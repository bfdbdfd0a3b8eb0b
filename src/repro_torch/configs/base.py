"""Config dataclasses for models and federated rounds.

A copy of the JAX package's ``configs/base.py`` (``MLAConfig``,
``MoEConfig``, ``SSMConfig``, ``EncoderConfig``, ``ModelConfig``,
``InputShape``, ``FedRoundSpec`` and ``TrainConfig``), field for field, so that a spec means the same in both packages.
``FedRoundSpec`` validates its names against the port's live
registries, as the reference does, so a name registered at run time
(``repro_torch.core.register_algorithm``, ``register_compressor``, ...)
builds a spec.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (MiniCPM3; the JAX package's
    ``MLAConfig``)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed mixture-of-experts FFN (the JAX package's ``MoEConfig``)."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    # layers [0, first_dense_layers) use a dense MLP instead of MoE
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    router_aux_coef: float = 0.001
    # the GShard dispatch's token group length and capacity factor
    gshard_group_size: int = 2048
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD state-space block (the JAX package's ``SSMConfig``)."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower of an encoder-decoder model (whisper; the JAX
    package's ``EncoderConfig``)."""

    num_layers: int
    num_frames: int  # the stub conv frontend's output length (whisper: 1500)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyper-parameters (the JAX package's ``ModelConfig``).

    ``ssm`` holds an :class:`SSMConfig` (the ``"M"`` and ``"Y"`` layers),
    ``encoder`` an :class:`EncoderConfig` (whisper's encoder tower and
    its decoder's cross-attention), ``mla`` an :class:`MLAConfig`
    (MiniCPM3's and DeepSeek-V3's attention), ``moe`` a
    :class:`MoEConfig` (the routed experts of qwen2-moe and
    DeepSeek-V3).
    """

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    layer_pattern: str = "F"
    sliding_window: int = 0
    mlp_kind: str = "silu_gated"  # silu_gated | gelu_gated | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    scale_embeddings: bool = False
    moe_impl: str = "ragged"
    # >0: streaming cross-entropy over vocab chunks of this size (never
    # materialises the (tokens, V) fp32 logits)
    loss_chunk_vocab: int = 0

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None

    num_prefix_tokens: int = 0

    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    remat: bool = True

    def pattern_for_layers(self) -> str:
        p = (self.layer_pattern * ((self.num_layers // len(self.layer_pattern)) + 1))
        return p[: self.num_layers]

    def layer_uses_moe(self, layer_idx: int) -> bool:
        return self.moe is not None and layer_idx >= self.moe.first_dense_layers

    def num_params(self) -> int:
        """Analytic parameter count."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


@dataclasses.dataclass(frozen=True)
class FedRoundSpec:
    """How one communication round maps onto a global batch.

    ``global_batch == num_sampled * local_steps * local_batch``. Every
    field and default is the JAX package's; see its ``configs/base.py``
    for what each beyond-paper knob does.
    """

    algorithm: str
    num_clients: int  # N
    num_sampled: int  # S
    local_steps: int  # K
    local_batch: int  # b_local
    eta_l: float = 0.05
    eta_g: float = 1.0
    scaffold_option: str = "II"  # I | II
    fedprox_mu: float = 1.0
    strategy: str = "client_parallel"  # client_parallel | client_sequential
    server_optimizer: str = ""
    server_momentum: float = 0.0
    server_beta1: float = 0.9
    server_beta2: float = 0.99
    server_eps: float = 1e-8
    compress: str = ""
    compress_uplink: dataclasses.InitVar[Optional[bool]] = None
    compress_k: int = 32
    compress_downlink: str = "none"
    weighted_aggregation: bool = False
    local_solver: str = "sgd"
    local_momentum: float = 0.9
    local_beta2: float = 0.99
    eta_l_schedule: str = ""
    privatizer: str = "none"
    clip_norm: float = 0.0
    noise_multiplier: float = 0.0
    dp_delta: float = 1e-5
    update_space: str = ""
    lora_rank: int = 0
    lora_alpha: float = 0.0
    update_targets: str = ""
    use_megakernel: bool = False

    def __post_init__(self, compress_uplink):
        # lazy import: the registries live above configs in the layering
        from repro_torch.core.api import (
            algorithm_names,
            get_algorithm,
            server_optimizer_names,
        )
        from repro_torch.core.compression import compressor_names
        from repro_torch.core.local_solver import local_solver_names
        from repro_torch.core.privatizer import (
            get_privatizer,
            privatizer_names,
        )
        from repro_torch.core.update_space import (
            get_update_space,
            update_space_names,
        )
        from repro_torch.optim.schedules import schedule_names

        assert self.algorithm in algorithm_names(), (
            self.algorithm, algorithm_names())
        assert self.server_optimizer in ("",) + server_optimizer_names(), (
            self.server_optimizer, server_optimizer_names())
        if self.local_solver == "":
            object.__setattr__(self, "local_solver", "sgd")
        assert self.local_solver in local_solver_names(), (
            self.local_solver, local_solver_names())
        assert 0.0 <= self.local_momentum < 1.0, self.local_momentum
        assert 0.0 <= self.local_beta2 < 1.0, self.local_beta2
        if self.local_solver == "sgd_sched":
            assert self.eta_l_schedule in schedule_names(), (
                f"local_solver='sgd_sched' needs eta_l_schedule in "
                f"{schedule_names()}, got {self.eta_l_schedule!r}")
        else:
            assert self.eta_l_schedule == "", (
                f"eta_l_schedule={self.eta_l_schedule!r} has no effect for "
                f"local_solver={self.local_solver!r}; use "
                f"local_solver='sgd_sched'")
        if self.compress == "":
            explicit = (compress_uplink
                        if isinstance(compress_uplink, bool) else False)
            object.__setattr__(
                self, "compress", "int8_ef" if explicit else "none")
        assert self.compress in compressor_names(), (
            self.compress, compressor_names())
        assert self.compress_downlink in compressor_names(), (
            self.compress_downlink, compressor_names())
        assert self.compress_k >= 1, self.compress_k
        if isinstance(compress_uplink, bool):
            assert compress_uplink == (self.compress != "none"), (
                f"compress_uplink={compress_uplink} contradicts "
                f"compress={self.compress!r}; set compress "
                f"('none' disables) instead of the back-compat flag")
        assert self.privatizer in privatizer_names(), (
            self.privatizer, privatizer_names())
        if get_privatizer(self.privatizer).clips:
            assert self.clip_norm > 0.0, (
                f"privatizer={self.privatizer!r} needs clip_norm > 0 "
                f"(the L2 sensitivity bound), got {self.clip_norm}")
            assert self.noise_multiplier > 0.0, (
                f"privatizer={self.privatizer!r} needs noise_multiplier > 0 "
                f"(z of the Gaussian mechanism), got "
                f"{self.noise_multiplier}")
            assert 0.0 < self.dp_delta < 1.0, (
                f"dp_delta must lie in (0, 1), got {self.dp_delta}")
            assert not self.weighted_aggregation, (
                f"privatizer={self.privatizer!r} noise is calibrated for "
                f"the uniform mean; weighted_aggregation is unsupported")
        else:
            assert self.clip_norm == 0.0, (
                f"clip_norm={self.clip_norm} has no effect for "
                f"privatizer={self.privatizer!r}")
            assert self.noise_multiplier == 0.0, (
                f"noise_multiplier={self.noise_multiplier} has no effect "
                f"for privatizer={self.privatizer!r}")
        if self.update_space == "":
            object.__setattr__(self, "update_space", "full")
        assert self.update_space in update_space_names(), (
            self.update_space, update_space_names())
        space = get_update_space(self.update_space)
        if space.uses_rank:
            assert self.lora_rank >= 1, (
                f"update_space={self.update_space!r} needs lora_rank >= 1, "
                f"got {self.lora_rank}")
            assert self.lora_alpha >= 0.0, self.lora_alpha
        else:
            assert self.lora_rank == 0, (
                f"lora_rank={self.lora_rank} has no effect for "
                f"update_space={self.update_space!r}")
            assert self.lora_alpha == 0.0, (
                f"lora_alpha={self.lora_alpha} has no effect for "
                f"update_space={self.update_space!r}")
        if space.requires_targets:
            assert self.update_targets != "", (
                f"update_space={self.update_space!r} needs update_targets "
                f"(an empty selection trains nothing)")
        if not space.trains_subset:
            assert self.update_targets == "", (
                f"update_targets={self.update_targets!r} has no effect for "
                f"update_space={self.update_space!r}")
        algo = get_algorithm(self.algorithm)
        if (self.server_optimizer == "" and self.server_momentum == 0.0
                and algo.default_server_optimizer == "momentum"):
            object.__setattr__(self, "server_momentum", 0.9)
        if algo.whole_batch:
            assert not self.weighted_aggregation, (
                f"weighted_aggregation has no effect for whole-batch "
                f"{self.algorithm!r}")
            assert self.server_optimizer in ("", "sgd"), (
                f"server_optimizer={self.server_optimizer!r} has no effect "
                f"for whole-batch {self.algorithm!r}")
            assert self.server_momentum == 0.0, (
                f"server_momentum has no effect for whole-batch "
                f"{self.algorithm!r}")
            assert self.compress == "none", (
                f"compress_uplink has no effect for whole-batch "
                f"{self.algorithm!r}")
            assert self.compress_downlink == "none", (
                f"compress_downlink has no effect for whole-batch "
                f"{self.algorithm!r}")
            assert self.privatizer == "none", (
                f"privatizer={self.privatizer!r} has no effect for "
                f"whole-batch {self.algorithm!r}")
            assert self.local_solver == "sgd", (
                f"local_solver={self.local_solver!r} has no effect for "
                f"whole-batch {self.algorithm!r}")
        assert self.scaffold_option in ("I", "II")
        assert self.strategy in ("client_parallel", "client_sequential")
        assert self.num_sampled <= self.num_clients

    @property
    def global_batch(self) -> int:
        return self.num_sampled * self.local_steps * self.local_batch


class _CompressUplinkMirror(int):
    """Truthy view of ``compress != "none"`` (an ``int`` subclass, so
    ``__post_init__`` tells the value ``dataclasses.replace`` re-passes
    apart from an explicit user bool)."""

    def __repr__(self):
        return repr(bool(self))


FedRoundSpec.compress_uplink = property(
    lambda self: _CompressUplinkMirror(self.compress != "none"))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    round_spec: FedRoundSpec
    seq_len: int = 1024
    rounds: int = 100
    seed: int = 0
    log_every: int = 10
    eval_every: int = 50
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
