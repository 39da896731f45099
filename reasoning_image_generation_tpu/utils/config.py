# config.py — generation configs, schema-compatible with the reference.
"""Generation configuration.

``GenConfig`` keeps the exact field names / defaults of the reference
dataclass (reference src/config.py:23-52) so downstream tooling and emitted
JSON stay compatible, and adds the device-batching knobs the reference does not
have (batch_size, device options).

``DEFAULT_CATEGORIES`` mirrors the two-level rule taxonomy of
reference src/config.py:6-21 verbatim (it is part of the public schema: the
sampled ``category_path`` is exported in meta.json).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

DEFAULT_CATEGORIES: Dict[str, Any] = {
    "图形相似": {
        "位置变换": ["平移", "旋转", "翻转(镜像)", "组合"],
        "叠加": ["直接叠加", "去同存异", "去异存同"],
    },
    "图形相异": {
        "图形遍历": ["单一遍历", "位置遍历"],
    },
}

# Leaves whose sequences run 6 frames instead of 4 (reference src/generator.py:262).
OVERLAY_LEAVES = ("直接叠加", "去同存异", "去异存同")

# All rule leaves in taxonomy order; index = on-device rule id.
RULE_LEAVES = (
    "平移",          # 0 translate
    "旋转",          # 1 rotate
    "翻转(镜像)",    # 2 flip
    "组合",          # 3 transform_many
    "直接叠加",      # 4 direct overlay
    "去同存异",      # 5 diff keep-different
    "去异存同",      # 6 diff keep-intersection
    "单一遍历",      # 7 kind traversal
    "位置遍历",      # 8 position traversal
)
RULE_ID = {name: i for i, name in enumerate(RULE_LEAVES)}

# The 11 shape kinds in the reference's sampling order
# (reference src/sample.py:151); index = on-device kind id.
SHAPE_KINDS = (
    "square", "circle", "triangle", "diamond", "star",
    "pentagon", "hexagon", "plus", "heart", "crescent", "rounded_square",
)
KIND_ID = {name: i for i, name in enumerate(SHAPE_KINDS)}


@dataclass
class GenConfig:
    """Schema-compatible generation config (reference src/config.py:23-52)."""

    out_dir: str = "./out"
    canvas_size: Tuple[int, int] = (512, 512)  # (W, H)
    grid_size: int = 3

    # appearance
    bg_color: Tuple[int, int, int] = (255, 255, 255)

    # randomness / reproducibility
    seed: Optional[int] = None

    # categories & sampling
    categories: Dict[str, Any] = field(
        default_factory=lambda: copy.deepcopy(DEFAULT_CATEGORIES))
    category_weights: Dict[str, float] = field(default_factory=dict)

    # export options
    export_coco: bool = True
    export_json: bool = True

    # sequence reasoning options
    seq_min: int = 2
    seq_max: int = 4
    num_options: int = 4
    shuffle_options: bool = True

    # ---- batched-build extensions (not in reference schema) ----
    # samples rendered per XLA program invocation
    batch_size: int = 64
    # max element slots in the struct-of-arrays state (reference worst case
    # is ~6 after an overlay merge of two 3-element frames)
    max_elems: int = 8
    # distractor retry budget, mirrors getattr(cfg,'max_distractor_retries',20)
    # (reference src/generator.py:428)
    max_distractor_retries: int = 20
    # per-sample wall clock guard is meaningless in a batched XLA program;
    # kept for schema compatibility with getattr probes.
    max_generation_time: int = 30
    # rasterizer: 'auto' picks the Pallas kernel on a GPU
    # (ops/raster_pallas.py) and the jnp path on the CPU; 'pallas' and
    # 'jnp' force one (utils/backend.auto_renderer)
    renderer: str = "auto"
    # sparse device->host transfer codec (ops/sparse.py): pack frames to a
    # 1-bit block mask + non-background 8x8 blocks; ~2x fewer bytes on the
    # link at ~40% extra device time — enable when the host link (not the
    # chip) is the bottleneck
    sparse_transfer: bool = False
    # non-background block budget as a fraction of the canvas; frames above
    # it fall back to a raw transfer.  Measured occupancy of 8x8 blocks on
    # production 512^2 state/option frames: p99 = 0.24, max = 0.31 — 0.35
    # covers everything observed with margin
    sparse_budget: float = 0.35
    # composed grids are denser (borders, labels, resized cells): measured
    # p99 = 0.46, max = 0.47
    sparse_budget_grid: float = 0.55
    # which codec sparse_transfer uses: 'rle5d'/'rle5' (the v4 wire
    # format with a 1-bit-per-run "length is 1" bitmask replacing the
    # length byte on single-pixel runs — the production median run is
    # one AA edge pixel), 'rle4d' (rle3d with u8 run
    # lengths — runs >255 pull their true u16 length from a compacted
    # extension stream; measured 28-33% fewer run bytes than the u16
    # format — the default), 'rle4' (same wire format, no inter-frame
    # delta), 'rle3d' (u16 lengths + inter-frame delta for state/option
    # frames — unchanged spans collapse to copy-from-base runs; 2.0x
    # fewer full-export bytes than rle3), 'rle3' (batch-compacted runs
    # + top-255 palette w/ escapes), 'rle2' (u16 run length + u8 RGB,
    # 5 bytes/run), 'rle' (u32 start + u32 packed color, 8 bytes/run),
    # or 'sparse' (8x8 block codec, ops/sparse.py).  All are lossless
    # with a raw-frame fallback on budget overflow.
    transfer_codec: str = "rle4d"
    # RLE run budgets (max runs per frame; overflow falls back to a raw
    # transfer).  Measured: state/option frames p50 ~2.4k runs, max 3.2k;
    # composed grids max ~8.2k.  0 = defaults: H*W/32 for frames
    # (default_budget), grid_h*W/12 for grids (default_grid_budget)
    rle_budget: int = 0
    rle_budget_grid: int = 0
    # meta/coco JSON formatting: False (default) writes compact JSON on
    # the C-accelerated encoder (6x faster; ~2-4 s of a 1k window);
    # True restores the reference's indent=2 byte format (reference
    # src/generator.py:596) — identical content either way
    pretty_json: bool = False
    # export only grid_%06d.png + meta/coco (per-frame state/option images
    # never leave the device): ~9x fewer bytes across the host link for
    # consumers that train on the composed puzzle alone
    grid_only: bool = False
    # AOT executable cache (utils/aot.py): persist compiled executables so
    # a cold process skips trace+lower+compile for every leaf pipeline.
    # Self-invalidating (package-source + jax-version + device fingerprint
    # in the key); False falls back to plain jit dispatch
    aot: bool = True
    # multi-chip data parallelism: 'auto' shards the batch over a 1-D device
    # mesh whenever >1 device is visible (the device-parallel equivalent of the
    # reference's process-pool fan-out, src/cli.py:85-129); True forces it,
    # False pins single-device execution
    use_mesh: Any = "auto"


def category_leaves(categories: Dict[str, Any]) -> list:
    """Flatten the two-level taxonomy into leaf paths.

    Mirrors the recursive traversal of reference src/generator.py:634-650.
    """
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, list):
            for item in node:
                leaves.append(path + [item])

    walk(categories, [])
    return leaves
