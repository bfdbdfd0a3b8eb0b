"""SCAFFOLD and its baselines in PyTorch (the JAX package's ``core``).

  run_round        — one communication round over typed states
  run_rounds       — R rounds of the scanned engine over a device store
  run_rounds_cohort — the same over a cohort-sized device buffer, the
                     population in the tiered host store
  federated_round  — the reference's tuple shim over run_round
  client_update    — one client's K corrected local steps
  FederatedTrainer — the host controller: the synchronous and pipelined
                     loops, the scanned engine (``scan_rounds``) and the
                     async buffered engine (``async_buffer``), over a
                     dense or tiered population store
  AsyncBufferedEngine, DispatchSimulator — the async engine and its
                     virtual-time event core
  device_sample_ids, DeviceClientSampler — the scanned engine's cohorts

Registries, each listable and open to user entries: ``Algorithm``
(``register_algorithm``), ``ServerOptimizer``, ``LocalSolver``,
``Compressor`` (uplink/downlink codecs with an error-feedback residual),
``Privatizer`` (clip, Gaussian noise, the ``dp_epsilon`` accountant),
``UpdateSpace`` (``full``, ``lora``, ``head_only``: the tree the engine
trains) and ``StoreBackend`` (``dense``, ``memmap``, ``sharded``: where
the population's rows live), ``AvailabilityModel`` (``always_on``,
``uniform``, ``lognormal``, ``trace``: when dispatched clients report
back, or die) and ``StalenessWeighting`` (``constant``, ``polynomial``,
``cutoff``: the weight of a stale buffered update).
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
    run_rounds,
    run_rounds_cohort,
    server_optimizer_names,
)
from repro_torch.core.async_engine import (  # noqa: F401
    AsyncBufferedEngine,
    StalenessWeighting,
    make_staleness_weighting,
    register_staleness_weighting,
    staleness_weighting_names,
)
from repro_torch.core.availability import (  # noqa: F401
    AvailabilityModel,
    AvailabilityTrace,
    Dispatch,
    DispatchSimulator,
    RecordingAvailability,
    TraceAvailability,
    availability_names,
    make_availability,
    record_trace,
    register_availability,
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
from repro_torch.core.sampling import (  # noqa: F401
    ClientSampler,
    DeviceClientSampler,
    device_sample_ids,
)
from repro_torch.core.store import (  # noqa: F401
    ClientStateStore,
    DenseBackend,
    MemmapBackend,
    StoreBackend,
    TieredClientStore,
    make_store_backend,
    refresh_rows,
    register_store_backend,
    stale_mask,
    store_backend_names,
)
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
