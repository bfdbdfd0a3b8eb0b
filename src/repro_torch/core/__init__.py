"""SCAFFOLD and its baselines in PyTorch (the JAX package's ``core``).

  run_round        — one communication round over typed states
  client_update    — one client's K corrected local steps
  FederatedTrainer — the synchronous host controller

Registries, each listable: ``algorithm_names``,
``server_optimizer_names``, ``local_solver_names``, ``compressor_names``
(uplink/downlink codecs with an error-feedback residual) and
``privatizer_names`` (clip, Gaussian noise, the ``dp_epsilon``
accountant).
"""
from repro_torch.core.api import (  # noqa: F401
    ClientRoundState,
    RoundOutput,
    ServerState,
    algorithm_names,
    get_algorithm,
    init_server_state,
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
    local_solver_names,
    megakernel_incompatibility,
    run_local_steps,
)
from repro_torch.core.privatizer import (  # noqa: F401
    Privatizer,
    get_privatizer,
    privatizer_names,
    register_privatizer,
    resolve_privatizer,
)
from repro_torch.core.rounds import client_update, run_round  # noqa: F401
