"""Architecture, runtime and serving configuration (plain dataclasses,
copied from ``repro/configs/base.py``).

`ArchConfig` is the identity of a model; `Runtime` holds execution knobs
that never change the model's math; `ServingConfig` the continuous-batching
knobs; `Shape` / `SHAPES` the assigned input-shape cells of the dry-run,
and `runnable` which of them a config takes.  The fields keep the JAX package's names and defaults so a config
means the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.qlinear import QuantConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    ffn_type: str = "swiglu"      # swiglu | gelu
    rope: str = "rope"            # rope | mrope | none (sinusoidal abs)
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_dense_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # hybrid: layer pattern repeated + tail
    pattern: Tuple[str, ...] = ("A",)
    tail: Tuple[str, ...] = ()
    local_window: int = 0         # >0: sliding-window attention
    lru_width: int = 0
    # misc
    norm_eps: float = 1e-6
    quant: QuantConfig = QuantConfig(backend="fake_quant")
    quant_plan: Optional[str] = None
    notes: str = ""
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        assert (self.n_layers - len(self.tail)) % len(self.pattern) == 0, self.name
        return (self.n_layers - len(self.tail)) // len(self.pattern)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128."""
        return -(-self.vocab // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """True iff decode cost/cache is O(1)-or-O(window) in context length,
        which is what long_500k requires (SSM state or local-window attn)."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.local_window > 0
        )

    def reduced(self, **overrides) -> "ArchConfig":
        """A small same-family config for CPU tests (the JAX package's
        reduction, field for field)."""
        base = dict(
            n_layers=len(self.pattern) + len(self.tail),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            n_experts=8 if self.n_experts else 0,
            d_ff_expert=64 if self.d_ff_expert else 0,
            moe_dense_ff=64 if self.moe_dense_ff else 0,
            ssm_state=32 if self.ssm_state else 0,
            ssm_headdim=16,
            ssm_chunk=16,
            local_window=16 if self.local_window else 0,
            lru_width=64 if self.lru_width else 0,
            mrope_sections=(2, 3, 3),
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class Shape:
    """An assigned input-shape cell."""

    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def runnable(arch: ArchConfig, shape: Shape) -> bool:
    """long_500k needs sub-quadratic attention (a full-attention config's
    cache and decode cost grow with the whole context)."""
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs; never change model math."""

    attn_impl: str = "chunked"      # chunked | full | flash (CUDA kernel)
    attn_chunk_q: int = 512
    # paged decode attention: "fused" runs kernels.ops.paged_decode_attention
    # on the pages in place; "gather" is the paged_read-then-attend baseline
    paged_attn: str = "fused"
    # uniform backend-string override, mapped to a uniform plan
    quant_backend: Optional[str] = None
    # quant plan spec: preset name | JSON path | inline "pattern=backend"
    # rules (core.quant_plan); takes precedence over quant_backend
    quant_plan: Optional[str] = None
    cache_dtype: str = "bfloat16"   # bfloat16 | float32 | int8 | int4
    compute_dtype: str = "bfloat16"
    # paged prefill attends over the gathered page pool (tail prefill after
    # a prefix-cache hit) instead of the in-flight K/V
    prefill_over_cache: bool = False
    # training: the cross-entropy over rows of this many tokens (0 =
    # unchunked), and what each block keeps for the backward (none: every
    # activation; dots: matmul outputs only; full: recompute the block)
    loss_chunk: int = 4096
    remat: str = "dots"             # none | dots | full

    def quant_cfg(self, arch: ArchConfig, site: str = "") -> QuantConfig:
        """Per-site QuantConfig under the active plan (`site` e.g.
        "block[3].attn.qkv"; "" resolves the plan default)."""
        from ..core.quant_plan import active_plan

        return active_plan(arch, self).resolve(site)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching serving knobs (see repro_torch.serving).

    `layout="paged"` allocates KV storage as fixed-size pages from a shared
    pool with per-sequence block tables; `"contiguous"` preallocates one
    `max_ctx`-long cache row per batch slot (the static-slot layout, and
    the one SSM stacks serve through).  Decode batches pad up to the
    nearest bucket, prompts to the nearest power-of-two length (SSM stacks:
    their exact length).
    `prefix_cache` reuses full KV pages across requests by chained prefix
    hash; `prefix_lru` keeps freed registered pages hittable until the
    free list runs dry.  `step="ragged"` packs every live request's tokens
    (chunked-prefill slices and decode tokens) into one flat
    ``[1, budget]`` step; `token_budget` is its padded capacity (0 = auto,
    see `budget`)."""

    layout: str = "paged"           # paged | contiguous
    max_batch: int = 8
    page_size: int = 16
    num_pages: int = 128
    max_ctx: int = 256
    decode_buckets: Tuple[int, ...] = ()
    prefix_cache: bool = True
    prefix_lru: bool = True
    step: str = "bucketed"          # bucketed | ragged
    token_budget: int = 0           # ragged step's rows per step, 0 = auto
    max_queue: int = 0              # bounded admission queue (0 = none)
    # watchdog deadline around each engine step (distributed.fault_tolerance
    # Watchdog): a step exceeding it bumps
    # serving_step_deadline_exceeded_total, and raises StepDeadlineExceeded
    # when strict.  0 = off.
    step_deadline_s: float = 0.0
    step_deadline_strict: bool = False

    def __post_init__(self):
        assert self.layout in ("paged", "contiguous"), self.layout
        assert self.step in ("bucketed", "ragged"), self.step
        assert self.step == "bucketed" or self.layout == "paged", \
            "the ragged step packs tokens through block tables (paged only)"
        assert self.max_ctx % self.page_size == 0, \
            f"max_ctx {self.max_ctx} must be a multiple of page_size {self.page_size}"
        assert self.max_queue >= 0 and self.step_deadline_s >= 0.0

    @property
    def budget(self) -> int:
        """Effective ragged token budget: the explicit one (the engine
        doubles it the step the decode set outgrows it), else every decode
        slot plus two pages of prefill chunk, padded to a power of two."""
        if self.token_budget:
            return self.token_budget
        return self.prompt_bucket(self.max_batch + 2 * self.page_size)

    @property
    def pages_per_seq(self) -> int:
        return self.max_ctx // self.page_size

    @property
    def buckets(self) -> Tuple[int, ...]:
        if self.decode_buckets:
            return tuple(sorted(set(self.decode_buckets) | {self.max_batch}))
        b, out = 1, []
        while b < self.max_batch:
            out.append(b)
            b *= 2
        return tuple(out) + (self.max_batch,)

    def decode_bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    @staticmethod
    def prompt_bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b
