"""Configs of the PyTorch port.

Copies of `repro.configs.base.ModelConfig` (and the layer-kind constants),
`StreamConfig` and `GenFVConfig`, kept here so the port never imports the
JAX package. Only the `ModelConfig` fields and methods the ported serving
path reads are carried: `reduced()`, `layer_kinds`, `padded_vocab_size` and
`param_count()` compute exactly what their JAX counterparts compute.
`GenFVConfig` and `StreamConfig` are data only, field for field and
default for default the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds used in repeating block patterns.
ATTN_GLOBAL = "global"    # full causal attention
ATTN_LOCAL = "local"      # sliding-window causal attention
BLOCK_MLSTM = "mlstm"     # xLSTM matrix-memory block
BLOCK_SLSTM = "slstm"     # xLSTM scalar-memory block
BLOCK_RGLRU = "rglru"     # RG-LRU recurrent block (Griffin)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_expert: int
    router_aux_loss: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    """One architecture at its full published size; `.reduced()` derives the
    smoke variant of the same family."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    head_dim: Optional[int] = None   # default: d_model // num_heads
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None     # tanh soft-cap on attention logits
    final_softcap: Optional[float] = None    # tanh soft-cap on LM-head logits
    sliding_window: Optional[int] = None     # window for ATTN_LOCAL layers
    rope_theta: float = 10000.0
    pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    mlp_type: str = "swiglu"                 # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None
    lru_width: Optional[int] = None          # RG-LRU recurrence width
    conv_kernel: int = 4                     # temporal-conv width in recurrent blocks
    proj_factor: float = 2.0                 # xLSTM up-projection factor
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    tie_embeddings: bool = True
    scale_embed: bool = False                # gemma-style sqrt(d_model) embed scaling
    encoder_layers: int = 0                  # >0 => encoder-decoder (whisper)
    encoder_seq: int = 1500
    modality: str = "text"                   # text | vision | audio
    frontend_tokens: int = 0
    # Pad the vocab up to a multiple (0 = off); padded logits are masked.
    pad_vocab_multiple: int = 0
    supports_long_context: bool = False
    long_context_note: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds, pattern tiled to num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return (self.pattern * reps)[: self.num_layers]

    @property
    def padded_vocab_size(self) -> int:
        if self.pad_vocab_multiple <= 0:
            return self.vocab_size
        m = self.pad_vocab_multiple
        return -(-self.vocab_size // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512, seq_cap: int = 128) -> "ModelConfig":
        """Smoke-test variant of the same family (same rule as the JAX
        package's `ModelConfig.reduced`)."""
        d_model = min(d_model, 512)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        head_dim = max(8, d_model // heads)
        moe = None
        if self.moe is not None:
            k = min(self.moe.experts_per_token, 2)
            moe = MoEConfig(num_experts=4, experts_per_token=k,
                            d_expert=max(8, d_model // 2),
                            router_aux_loss=self.moe.router_aux_loss)
        pattern = tuple(dict.fromkeys(self.pattern))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            pattern=pattern,
            num_layers=max(num_layers, len(pattern)),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=0 if self.d_ff == 0 else max(16, d_model * 2),
            vocab_size=min(self.vocab_size, vocab),
            sliding_window=None if self.sliding_window is None else min(self.sliding_window, seq_cap // 2),
            lru_width=None if self.lru_width is None else d_model,
            moe=moe,
            encoder_layers=0 if self.encoder_layers == 0 else 2,
            encoder_seq=min(self.encoder_seq, 64),
            frontend_tokens=min(self.frontend_tokens, 16),
        )

    def param_count(self) -> int:
        return sum(self._param_terms().values())

    def _param_terms(self) -> dict:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        terms = {"embed": self.vocab_size * d}
        if not self.tie_embeddings:
            terms["lm_head"] = self.vocab_size * d
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        mlp = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * self.d_ff
        n_attn = n_mlp = n_rec = n_moe = 0
        for kind in self.layer_kinds:
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                n_attn += 1
                if self.moe is not None:
                    n_moe += 1
                elif self.d_ff > 0:
                    n_mlp += 1
            elif kind == BLOCK_RGLRU:
                n_rec += 1
                n_mlp += 1
            elif kind in (BLOCK_MLSTM, BLOCK_SLSTM):
                n_rec += 1
        terms["attn"] = n_attn * attn
        terms["mlp"] = n_mlp * mlp
        if self.moe is not None:
            e = self.moe
            expert = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * e.d_expert
            terms["moe_experts"] = n_moe * e.num_experts * expert
            terms["moe_router"] = n_moe * d * e.num_experts
        if n_rec:
            if self.family == "ssm":
                inner = int(d * self.proj_factor)
                per = d * inner * 2 + 3 * inner * inner // max(self.num_heads, 1) + inner * d
            else:
                w = self.lru_width or d
                per = 2 * d * w + 3 * w + w * self.conv_kernel + w * d + 2 * w * w
            terms["recurrent"] = n_rec * per
        if self.encoder_layers:
            terms["encoder"] = self.encoder_layers * (attn * 2 + mlp)
        terms["norms"] = 2 * self.num_layers * d + d
        return terms


# ---------------------------------------------------------------------------
# Streaming RSU round policy (fl/stream.py). Grouped here (rather than on
# GenFVConfig) because these are SERVICE knobs — how the RSU commits rounds —
# not physical-layer parameters; RunConfig carries one as `stream`.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class StreamConfig:
    """Quorum / retry / cadence policy for the event-driven streaming round
    engine (fl/stream.py, the JAX package's `fl/stream.py`). Frozen + flat
    so it rides inside the frozen `RunConfig` (hashable grid cells,
    JSON-able checkpoints).

    The defaults reproduce the synchronous round loop exactly: quorum=1.0
    commits on the last planned upload, cadence 0 fires rounds back-to-back,
    and with no fault schedule attached no retry is ever scheduled
    """
    # Fraction of the round's SELECTED uploads that must arrive before the
    # RSU commits (quorum count = ceil(quorum * K), floored at 1).
    quorum: float = 1.0
    # Minimum virtual seconds between consecutive round starts; 0 = a new
    # round fires the instant the previous one commits (sync semantics).
    cadence_s: float = 0.0
    # Degradation rung 1: when the quorum misses the planned close t_bar,
    # the deadline is extended ONCE to t_bar * (1 + deadline_slack).
    deadline_slack: float = 0.25
    # Upload retries after a failed (deep-faded) attempt, with capped
    # exponential backoff: wait min(backoff * 2^a, cap) before attempt a+1.
    retry_budget: int = 2
    retry_backoff_s: float = 0.25
    retry_backoff_cap_s: float = 2.0
    # Merge-on-arrival discount for uploads landing after their round's
    # commit: weight ∝ size * discount^age, dropped past max_staleness
    # rounds (mirrors FaultSpec's recovery policy, but streaming needs it
    # even without a fault schedule — quorum < 1 makes on-time stragglers).
    staleness_discount: float = 0.5
    max_staleness: int = 2

    def __post_init__(self):
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"quorum={self.quorum} outside (0, 1]")
        if self.cadence_s < 0.0:
            raise ValueError("cadence_s must be >= 0")
        if self.deadline_slack < 0.0:
            raise ValueError("deadline_slack must be >= 0")
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        if self.retry_backoff_s <= 0.0:
            raise ValueError("retry_backoff_s must be > 0")
        if self.retry_backoff_cap_s < self.retry_backoff_s:
            raise ValueError("retry_backoff_cap_s must be >= retry_backoff_s")
        if not 0.0 < self.staleness_discount <= 1.0:
            raise ValueError("staleness_discount must be in (0, 1]")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")

    def to_payload(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_payload(cls, payload: dict) -> "StreamConfig":
        return cls(**payload)


# ---------------------------------------------------------------------------
# FL / GenFV experiment config (paper Section VI defaults).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GenFVConfig:
    num_vehicles: int = 40            # vehicles in RSU range (Poisson mean)
    num_subcarriers: int = 20         # M
    # Per-subchannel bandwidth. The paper fixes M=20 subcarriers but leaves W
    # unspecified; 10 MHz makes a ResNet-18 upload ~2.3 s on one subcarrier,
    # matching the paper's t_max ~ 3 s operating point (Fig. 7).
    subcarrier_bw: float = 1e7        # W per subchannel (Hz)
    noise_power_dbm: float = -174.0   # N0
    phi_min: float = 0.1              # W
    phi_max: float = 1.0              # W
    rsu_tx_power_dbm: float = 40.0
    path_loss_exp: float = 2.0        # gamma
    unit_channel_gain: float = 1e-5   # h0
    rsu_radius: float = 500.0         # r (m)
    rsu_road_offset: float = 10.0     # e (m)
    v_max: float = 120.0              # km/h
    v_min: float = 10.0
    m_max: int = 60                   # max vehicles on road segment
    sigma_k: float = 0.1              # sigma = k * v_bar
    t_max: float = 3.0                # max round time (s)
    # Per-round energy budget. Unspecified in the paper; the eq. 6-8 GPU
    # model puts local training alone at 6-19 J, so 20 J makes the energy
    # constraint bind for slow-GPU vehicles without rejecting the fleet.
    e_max: float = 20.0               # per-round energy budget (J)
    local_steps: int = 4              # h
    # RSU augmented-model steps per round = rsu_steps_factor * h. The RSU GPU
    # is ~8x a vehicle GPU (Sec. IV-A5), so it fits more SGD inside the
    # straggler window it is already waiting through.
    rsu_steps_factor: int = 4
    lr: float = 1e-4
    batch_size: int = 64
    dirichlet_alpha: float = 0.1
    emd_threshold: float = 1.5        # \hat{EMD} (Table I)
    # diffusion service
    diffusion_steps: int = 50         # I
    gen_batch: int = 64               # images per generation batch
    # --- SUBP2-4 solver hyperparameters (Algorithms 1-3) -------------------
    # Read by BOTH the numpy reference solvers (core/bandwidth.py,
    # core/power.py) and the batched device planner (core/planner.py); the
    # defaults are the JAX package's.
    bw_l_min: float = 0.05            # SUBP2 fractional-subcarrier floor
    bw_step: float = 0.05             # Algorithm 1 subgradient step
    bw_max_iter: int = 500            # Algorithm 1 iteration cap
    bw_tol: float = 1e-5              # Algorithm 1 fixed-point tolerance
    sca_max_iter: int = 50            # Algorithm 2 SCA iteration cap
    sca_eps: float = 1e-4             # Algorithm 2 fixed-point tolerance
    bcd_eps: float = 1e-3             # Algorithm 3 outer BCD tolerance
    bcd_max_iter: int = 20            # Algorithm 3 outer BCD cap
    # --- sim persistent-world layer (Sec. V-A2 made stateful) --------
    # Poisson arrival rate at the coverage edges (veh/s, both directions
    # combined). The default keeps the equilibrium population near
    # num_vehicles for the nominal geometry/speeds. Ignored by the legacy
    # memoryless per-round sampler.
    arrival_rate: float = 1.1
    # AR(1) log-normal shadowing on the uplink channel gain h0: stationary
    # std-dev (dB) and decorrelation time constant (s). 0 dB disables
    # shadowing, which is the legacy memoryless channel.
    shadow_sigma_db: float = 0.0
    shadow_corr_time: float = 20.0
