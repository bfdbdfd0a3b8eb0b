"""SCAFFOLD and its baselines in PyTorch (the JAX package's ``core``).

  run_round        — one communication round over typed states
  federated_round  — the reference's tuple shim over run_round
  client_update    — one client's K corrected local steps
  FederatedTrainer — the synchronous host controller

Registries, each listable and open to user entries: ``Algorithm``
(``register_algorithm``), ``ServerOptimizer``, ``LocalSolver``,
``Compressor`` (uplink/downlink codecs with an error-feedback residual),
``Privatizer`` (clip, Gaussian noise, the ``dp_epsilon`` accountant) and
``UpdateSpace`` (``full``, ``lora``, ``head_only``: the tree the engine
trains). The JAX package's store-backend, availability and
staleness-weighting registries are not ported yet.
"""
from repro_torch.core.api import (  # noqa: F401
    Algorithm,
    ClientRoundState,
    RoundOutput,
    ServerOptimizer,
    ServerState,
    algorithm_names,
    get_algorithm,
    get_server_optimizer,
    init_server_state,
    register_algorithm,
    register_server_optimizer,
    resolve_server_optimizer,
    server_optimizer_names,
)
from repro_torch.core.compression import (  # noqa: F401
    Compressor,
    compressor_names,
    get_compressor,
    register_compressor,
    resolve_compressor,
    round_comm_bytes,
)
from repro_torch.core.controller import (  # noqa: F401
    FederatedTrainer,
    make_grad_fn,
)
from repro_torch.core.local_solver import (  # noqa: F401
    LocalSolver,
    get_local_solver,
    local_sgd,
    local_solver_names,
    megakernel_incompatibility,
    register_local_solver,
    resolve_local_solver,
    run_local_steps,
)
from repro_torch.core.privatizer import (  # noqa: F401
    Privatizer,
    get_privatizer,
    privatizer_names,
    register_privatizer,
    resolve_privatizer,
)
from repro_torch.core.rounds import (  # noqa: F401
    client_update,
    federated_round,
    run_round,
)
from repro_torch.core.sampling import ClientSampler  # noqa: F401
from repro_torch.core.store import ClientStateStore  # noqa: F401
from repro_torch.core.update_space import (  # noqa: F401
    FullSpace,
    HeadOnlySpace,
    LoRASpace,
    UpdateSpace,
    get_update_space,
    register_update_space,
    resolve_update_space,
    update_space_names,
)
