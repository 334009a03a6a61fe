"""Config system: architectures and input shapes (port of
``repro/configs/base.py``).

``ModelConfig``, ``ShapeConfig``, the shape cells and ``reduced()`` are
the reference's, field for field, so a config means the same model in
both packages. The registry holds every reference architecture: dense,
MoE and the VLM backbone (``models/transformer.py``), the hybrid
(``models/hymba.py``), the SSM (``models/xlstm.py``) and the
encoder-decoder (``models/encdec.py``). ``TrainConfig`` holds the
optimizer and loop settings of ``train/``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"  # enc-dec


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell for an architecture."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assignment's four LM shapes.
TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    head_dim: int = 0  # 0 => derived d_model // num_heads
    rope_theta: float = 500_000.0
    norm: str = "rms"  # "rms" | "nonparam_ln"
    # sliding-window attention: 0 = full attention everywhere.
    window: int = 0
    # every Nth layer uses full (global) attention when window > 0.
    global_every: int = 8

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 2
    moe_ff: int = 0  # expert hidden size (defaults to d_ff)
    dense_residual_ff: int = 0  # arctic: parallel dense MLP hidden size
    # expert-weight sharding: "dmodel" = FSDP over d_model (weights gathered
    # per use); "ff" = shard the expert hidden dim (weights stationary,
    # token partials reduce instead — see EXPERIMENTS.md §Perf/arctic)
    moe_shard: str = "dmodel"

    # --- SSM / hybrid ---
    ssm_state: int = 0  # mamba state size (hymba)
    ssm_heads: int = 0  # number of parallel mamba heads (hymba)
    slstm_every: int = 0  # xlstm: every Nth block is sLSTM (0 = none)
    mlstm_chunk: int = 64  # chunk size for chunked-parallel mLSTM

    # --- enc-dec ---
    enc_layers: int = 0  # >0 => encoder-decoder (num_layers = decoder layers)
    frontend: str = "none"  # "none" | "vit_stub" | "audio_stub"
    frontend_tokens: int = 0  # stub frames/patches prepended / fed to encoder

    # --- numerics / distribution knobs (defaults; overridable per run) ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "block"  # "none" | "block" (remat each scanned block)
    # >0: remat GROUPS of this many layers (outer scan over groups, inner
    # scan inside the checkpoint) — carries are saved per group instead of
    # per layer, cutting checkpoint memory by the group factor at the cost
    # of recomputing a group at a time in backward.
    remat_group: int = 0
    fsdp: bool = True  # shard params over the data axis too
    scan_layers: bool = True

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so (vocab % tp*fsdp == 0) on the
        production meshes — standard TPU practice. Loss masks pad columns."""
        return -(-self.vocab_size // 256) * 256

    # Head padding: attention heads padded to a multiple of the production
    # TP width (16) so the head dim shards exactly; padded heads are masked
    # to zero in the output projection, so the math equals the unpadded
    # architecture (see DESIGN.md §hardware-adaptation).
    head_pad_multiple: int = 16

    def hp(self) -> int:
        """Padded q-head count."""
        m = self.head_pad_multiple
        if m <= 1 or self.num_heads % m == 0:
            return self.num_heads
        return -(-self.num_heads // m) * m

    def kvp(self) -> int:
        """Padded kv-head count: smallest kv' >= kv with hp() % kv' == 0."""
        hp = self.hp()
        kv = min(self.num_kv_heads, hp)
        while hp % kv != 0:
            kv += 1
        return kv

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def expert_ff(self) -> int:
        return self.moe_ff or self.d_ff

    # --- shape-cell applicability (assignment rules) -----------------------
    def subquadratic(self) -> bool:
        """True when decode over a 512k context does not need full attention."""
        return self.family in (SSM, HYBRID)

    def shape_cells(self) -> List[ShapeConfig]:
        cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.subquadratic():
            cells.append(LONG_500K)
        return cells

    def skipped_cells(self) -> List[Tuple[str, str]]:
        out = []
        if not self.subquadratic():
            out.append(("long_500k", "pure full-attention arch; 512k decode "
                        "requires sub-quadratic attention (assignment rule)"))
        return out

    # --- parameter counting (for roofline MODEL_FLOPS) ---------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count. active_only counts top-k experts only."""
        d, hd = self.d_model, self.hd()
        emb = self.vocab_size * d
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.family == SSM:
            # xlstm block: qkv-ish projections + gates + out; approx per block
            per_block = 4 * d * d + 4 * d  # q,k,v,o plus gate vectors
            blocks = self.num_layers * per_block
            return emb + blocks + d * self.vocab_size
        mlp_dense = 3 * d * self.d_ff if self.d_ff else 0
        per_layer = attn + mlp_dense
        if self.is_moe:
            n_exp = self.top_k if active_only else self.num_experts
            per_layer += 3 * d * self.expert_ff() * n_exp
            per_layer += d * self.num_experts  # router
            if self.dense_residual_ff:
                per_layer += 3 * d * self.dense_residual_ff
        if self.family == HYBRID:
            # mamba head branch: in/out proj + ssm params
            dm = self.ssm_heads * hd
            per_layer += 2 * d * dm + dm * (2 * self.ssm_state + 2) + dm
        total = emb + self.num_layers * per_layer + d * self.vocab_size
        if self.is_encdec:
            enc_layer = attn + mlp_dense
            cross = attn  # cross-attention per decoder layer
            total += self.enc_layers * enc_layer + self.num_layers * cross
        return total

    # --- reduced config for CPU smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        kw = dict(
            num_layers=max(2, min(2, self.num_layers)),
            d_model=64,
            num_heads=4,
            num_kv_heads=2 if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            remat="none",
            fsdp=False,
            head_pad_multiple=1,
        )
        if self.is_moe:
            kw.update(num_experts=4, moe_ff=64,
                      dense_residual_ff=64 if self.dense_residual_ff else 0)
        if self.family == HYBRID:
            kw.update(ssm_heads=2, ssm_state=4, window=16, global_every=2)
        if self.family == SSM:
            kw.update(mlstm_chunk=8)
        if self.is_encdec:
            kw.update(enc_layers=2)
        if self.frontend_tokens:
            kw.update(frontend_tokens=8)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, ModelConfig] = {}

def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        internvl2_1b, olmo_1b, llama3_8b, yi_9b, deepseek_7b, mqrld_paper,
        phi35_moe_42b, arctic_480b, hymba_1_5b, xlstm_1_3b,
        seamless_m4t_medium,
    )


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1  # grad-accumulation steps per global step
    grad_compress: bool = False  # int8 + error feedback on cross-pod axis
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
