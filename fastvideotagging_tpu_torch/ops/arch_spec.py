"""Declarative serving-walk specs (the counterpart of
``fastvideotagging_tpu/ops/arch_spec.py``): one source of truth for the
block structure that the int8 engine (ops/int8_infer.py) interprets.

A tiny frozen IR plus one builder per architecture; the bf16 reference
walk, the calibration pass, the quantizer and the int8 engine all walk the
same spec. The data is the JAX package's, field for field: site names,
kernel paths and ``conv_id``s are the qpack's keys, so both packages'
qpacks index alike. Node semantics (eval mode):

* ``Conv``    - conv (symmetric k//2 padding, or TF-SAME) + optional folded
  BatchNorm affine or bias + optional ReLU. ``site`` names the INPUT
  tensor: the quantization point shared by every conv that reads it (the
  consumers map for weight smoothing).
* ``MaxPool`` - window max-pool (C3D, P3D, S3D, I3D).
* ``Sum``     - two conv chains added: ``right_from='input'`` is P3D-B's
  S(x)+T(x), ``right_from='left'`` P3D-C's S(x)+T(S(x)).
* ``Block``   - residual block: relu(main(x) + down(x)); ``key`` is the
  mixed-precision granularity (``float_blocks``).
* ``Branches`` - Inception node: branches on one input, channel-concatenated.
* ``Dense``   - head layer (gap: f32 matmul; flatten: model dtype).
* ``Subsample`` / ``Stream`` / ``Fuse`` - the SlowFast dual-pathway nodes
  over an environment of named streams (``ArchSpec.head_streams``).

Paths in a spec name the JAX variables tree. ``param_key`` resolves one to
the port's ``state_dict`` key by the rule of models/convert.py: the path
joined with ``.``, the ``BatchNorm_0`` level dropped, a Dense ``kernel``
the port's ``weight`` transposed (``param``).
"""


from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------


def tf_same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME padding for one dim: out = ceil(size/s), the EXTRA pixel on
    the high side (TensorFlow semantics; i3d). For stride 1 and odd k this
    equals the symmetric k//2 — it only differs on strided even inputs."""
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return (pad // 2, pad - pad // 2)


@dataclasses.dataclass(frozen=True)
class Conv:
    site: str                      # input-site name (quantization point)
    kernel: Tuple[str, ...]        # params path to the (kt,kh,kw,ci,co) kernel
    strides: Tuple[int, int, int]
    bn: Optional[Tuple[str, ...]] = None    # path to a layers.Norm wrapper
    bias: Optional[Tuple[str, ...]] = None  # path to a bias vector (C3D)
    relu: bool = True
    bn_eps: float = 1e-5  # folded into the requant affine (s3d uses 1e-3)
    # None -> symmetric k//2 (torch/MXNet semantics, the package default);
    # 'same_tf' -> TF-SAME computed from the traced input shape (i3d stem)
    padding: Optional[str] = None
    # S3D-G self-gating (models/s3d.py SepConv): params path to a Dense
    # {kernel, bias}; the conv output is scaled per-channel by
    # sigmoid(Dense(f32 spatiotemporal mean of the output)). Data-dependent
    # like dynamic amax; the engines apply it as an f32 epilogue.
    gate: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class MaxPool:
    window: Tuple[int, int, int]
    strides: Tuple[int, int, int]
    # 'VALID' | 'SAME' | 'SAME_TF' (shape-dependent, i3d) | tuple of 3
    # (lo, hi) pairs over (T, H, W)
    padding: Tuple = "VALID"


@dataclasses.dataclass(frozen=True)
class Sum:
    left: Tuple[Conv, ...]
    right: Tuple[Conv, ...]
    right_from: str = "input"  # 'input' (P3D-B) | 'left' (P3D-C)


@dataclasses.dataclass(frozen=True)
class Block:
    key: str
    main: Tuple  # Conv | Sum nodes; last conv has relu=False (post-add relu)
    down: Optional[Conv] = None  # None -> identity residual


@dataclasses.dataclass(frozen=True)
class Branches:
    """Inception node: every branch (a tuple of Conv | MaxPool) consumes
    the node input; the output is the channel concat of the branch outputs
    in order (S3D's SepInception). Branch-entry convs share the node-input
    site name, so the smoothing-consumers map sees all of them."""
    branches: Tuple[Tuple, ...]


@dataclasses.dataclass(frozen=True)
class Dense:
    param: Tuple[str, ...]  # params path to {kernel, bias}
    relu: bool = False


@dataclasses.dataclass(frozen=True)
class Subsample:
    """env[dst] = env[src][:, ::stride] — pathway split (SlowFast slow).

    ``pack`` > 1 additionally folds that many consecutive frames into the
    channel dim ((N,T,H,W,C) -> (N,T/pack,H,W,pack*C)) AFTER the stride —
    the `slowfast_r2plus1d_tpu` time-to-channel fast pathway
    (models/slowfast.py pack_fast)."""
    src: str
    dst: str
    stride: int
    pack: int = 1


@dataclasses.dataclass(frozen=True)
class Stream:
    """Run ``nodes`` (Conv | MaxPool | Block) on the named stream."""
    name: str
    nodes: Tuple


@dataclasses.dataclass(frozen=True)
class Fuse:
    """env[dst] = concat(env[dst], conv(env[src])) — SlowFast lateral."""
    src: str
    dst: str
    conv: Conv


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    nodes: Tuple  # Conv | MaxPool | Block | Branches | Subsample | Stream | Fuse
    # 'gap' (global avg pool, f32) | 'flatten' | 'gap_t2' (S3D head: f32
    # spatial mean -> temporal window-2 stride-1 mean -> temporal mean)
    head_pool: str
    head: Tuple[Dense, ...]
    # blocks kept in bf16 by default in the int8 engine (measured
    # residual-cancellation tails; ops/int8_infer module docstring)
    default_float_blocks: Tuple[str, ...] = ()
    # streams pooled + concatenated (in order) before the head; empty ->
    # the linear single-stream walk on the implicit stream "x"
    head_streams: Tuple[str, ...] = ()
    # int8 engine: default to DYNAMIC per-batch activation scales for this
    # architecture (s3d: static calibrated scales measure 0.93 vs bf16's
    # 0.96 top-1 on the hard benchmark — branch-site calibration drift;
    # dynamic restores full parity, benchmarks/INT8_S3D.json)
    default_dynamic: bool = False
    # int8 engine: calibrate per-site static headroom margins
    # (calibrate(return_margins=True)) instead of the global 2.0 — the
    # branch-site-aware STATIC mode. Sites whose calibration absmax swings
    # across batches get proportionally more clip headroom, which recovers
    # the Inception families' branch-site drift without the dynamic amax
    # pass's throughput cost (measured: benchmarks/INT8_INCEPTION.json).
    default_site_margins: bool = False


def iter_convs(spec: ArchSpec):
    """Yield (block_key | None, Conv) over every conv in walk order."""
    def from_main(key, nodes):
        for n in nodes:
            if isinstance(n, Conv):
                yield key, n
            elif isinstance(n, Sum):
                for c in n.left:
                    yield key, c
                for c in n.right:
                    yield key, c

    def walk(nodes):
        for node in nodes:
            if isinstance(node, Conv):
                yield None, node
            elif isinstance(node, Block):
                yield from from_main(node.key, node.main)
                if node.down is not None:
                    yield node.key, node.down
            elif isinstance(node, Branches):
                for branch in node.branches:
                    yield from walk(branch)
            elif isinstance(node, Stream):
                yield from walk(node.nodes)
            elif isinstance(node, Fuse):
                yield None, node.conv

    yield from walk(spec.nodes)


def conv_id(c: Conv) -> str:
    """Stable qpack key for a conv: its kernel path sans the leaf name."""
    return ".".join(c.kernel[:-1])


# ---------------------------------------------------------------------------
# Architecture builders (mirror models/{r2plus1d,p3d,c3d}.py)
# ---------------------------------------------------------------------------


def r2plus1d_spec(stage_blocks: Tuple[int, ...] = (2, 2, 2, 2)) -> ArchSpec:
    """R(2+1)D-18/34 (+ `_tpu` variants — same structure, wider mids).

    Mirrors models/r2plus1d.py: stem (1x7x7 s1,2,2 -> 3x1x1) then basic
    blocks of two factorized pairs; downsample at stage entries 2-4.
    Site names are the round-2 engine's (qpack compatibility).
    """
    nodes = [
        Conv("input", ("stem_spatial", "kernel"), (1, 2, 2),
             bn=("stem_bn1",)),
        Conv("stem_mid", ("stem_temporal", "kernel"), (1, 1, 1),
             bn=("stem_bn2",)),
    ]
    for stage, num_blocks in enumerate(stage_blocks):
        for block in range(num_blocks):
            s = 2 if (stage > 0 and block == 0) else 1
            key = f"stage{stage + 1}_block{block}"
            main = (
                Conv(f"{key}.in", (key, "conv1", "spatial", "kernel"),
                     (1, s, s), bn=(key, "conv1", "bn_mid")),
                Conv(f"{key}.conv1.mid", (key, "conv1", "temporal", "kernel"),
                     (s, 1, 1), bn=(key, "bn1")),
                Conv(f"{key}.conv2.in", (key, "conv2", "spatial", "kernel"),
                     (1, 1, 1), bn=(key, "conv2", "bn_mid")),
                Conv(f"{key}.conv2.mid", (key, "conv2", "temporal", "kernel"),
                     (1, 1, 1), bn=(key, "bn2"), relu=False),
            )
            down = (Conv(f"{key}.in", (key, "downsample", "kernel"),
                         (s, s, s), bn=(key, "bn_down"), relu=False)
                    if s != 1 else None)
            nodes.append(Block(key, main, down))
    tail = tuple(f"stage4_block{b}" for b in range(stage_blocks[3]))
    return ArchSpec(tuple(nodes), "gap", (Dense(("fc",)),),
                    default_float_blocks=tail)


def p3d_spec(stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)) -> ArchSpec:
    """P3D-63/131/199: bottleneck blocks with the A->B->C cycle.

    Mirrors models/p3d.py. Downsample (1x1x1, stride (1,s,s)) at every
    stage entry (including stage 1, where cin 64 != cout 256).
    """
    nodes = [
        Conv("input", ("stem_conv", "kernel"), (1, 2, 2), bn=("stem_bn",)),
        MaxPool((2, 3, 3), (2, 2, 2), padding=((0, 0), (1, 1), (1, 1))),
    ]
    idx = 0
    for stage, num_blocks in enumerate(stage_blocks):
        for block in range(num_blocks):
            s = 2 if (stage > 0 and block == 0) else 1
            key = f"stage{stage + 1}_block{block}"
            btype = "ABC"[idx % 3]
            idx += 1
            spatial = lambda site: Conv(  # noqa: E731
                site, (key, "spatial", "kernel"), (1, 1, 1),
                bn=(key, "bn_s"))
            temporal = lambda site: Conv(  # noqa: E731
                site, (key, "temporal", "kernel"), (1, 1, 1),
                bn=(key, "bn_t"))
            mid = f"{key}.mid"
            if btype == "A":
                st = (spatial(mid), temporal(f"{key}.s"))
            elif btype == "B":
                st = (Sum((spatial(mid),), (temporal(mid),),
                          right_from="input"),)
            else:  # C: ys + T(ys)
                st = (Sum((spatial(mid),), (temporal(f"{key}.s"),),
                          right_from="left"),)
            main = (
                Conv(f"{key}.in", (key, "reduce", "kernel"), (1, s, s),
                     bn=(key, "bn_reduce")),
                *st,
                Conv(f"{key}.exp", (key, "expand", "kernel"), (1, 1, 1),
                     bn=(key, "bn_expand"), relu=False),
            )
            down = (Conv(f"{key}.in", (key, "downsample", "kernel"),
                         (1, s, s), bn=(key, "bn_down"), relu=False)
                    if block == 0 else None)
            nodes.append(Block(key, main, down))
    tail = tuple(f"stage4_block{b}" for b in range(stage_blocks[3]))
    return ArchSpec(tuple(nodes), "gap", (Dense(("fc",)),),
                    default_float_blocks=tail)


def c3d_spec() -> ArchSpec:
    """C3D: 8 conv3d(+bias, no BN) / 5 maxpool / flatten-MLP head.

    Mirrors models/c3d.py (paper-faithful: no norm layers; biased convs).
    No residual structure -> no default bf16 tail.
    """
    def conv(site, name):
        return Conv(site, (name, "kernel"), (1, 1, 1), bias=(name, "bias"))

    nodes = (
        conv("input", "conv1"),
        MaxPool((1, 2, 2), (1, 2, 2)),
        conv("pool1", "conv2"),
        MaxPool((2, 2, 2), (2, 2, 2)),
        conv("pool2", "conv3a"),
        conv("conv3a", "conv3b"),
        MaxPool((2, 2, 2), (2, 2, 2)),
        conv("pool3", "conv4a"),
        conv("conv4a", "conv4b"),
        MaxPool((2, 2, 2), (2, 2, 2)),
        conv("pool4", "conv5a"),
        conv("conv5a", "conv5b"),
        MaxPool((2, 2, 2), (2, 2, 2), padding=((0, 0), (1, 1), (1, 1))),
    )
    head = (Dense(("fc6",), relu=True), Dense(("fc7",), relu=True),
            Dense(("fc8",)))
    return ArchSpec(nodes, "flatten", head)


def videoresnet_spec(stage_conv_types: Tuple[str, ...] = ("3d",) * 4,
                     stage_blocks: Tuple[int, ...] = (2, 2, 2, 2)) -> ArchSpec:
    """r3d_18 / mc3_18 (models/videoresnet.py): plain-Conv3d BasicBlocks.

    The conv type only changes kernel shapes (carried by the params) and
    strides: '3d' downsamples (s,s,s), 'no_t' (1,s,s) — mirroring
    Block3D's get_downsample_stride behavior."""
    nodes = [
        Conv("input", ("stem_conv", "kernel"), (1, 2, 2), bn=("stem_bn",)),
    ]
    for stage, (num_blocks, ctype) in enumerate(
            zip(stage_blocks, stage_conv_types)):
        for block in range(num_blocks):
            s = 2 if (stage > 0 and block == 0) else 1
            key = f"stage{stage + 1}_block{block}"
            cstride = (s, s, s) if ctype == "3d" else (1, s, s)
            main = (
                Conv(f"{key}.in", (key, "conv1", "kernel"), cstride,
                     bn=(key, "bn1")),
                Conv(f"{key}.c1", (key, "conv2", "kernel"), (1, 1, 1),
                     bn=(key, "bn2"), relu=False),
            )
            down = (Conv(f"{key}.in", (key, "downsample", "kernel"),
                         cstride, bn=(key, "bn_down"), relu=False)
                    if s != 1 else None)
            nodes.append(Block(key, main, down))
    tail = tuple(f"stage4_block{b}" for b in range(stage_blocks[3]))
    return ArchSpec(tuple(nodes), "gap", (Dense(("fc",)),),
                    default_float_blocks=tail)


def s3d_spec(gating: bool = False) -> ArchSpec:
    """S3D / S3D-G (models/s3d.py, torchvision geometry).

    Separable convs are (1xkxk, bn_s, relu) -> (kx1x1, bn_t, relu) pairs;
    the nine SepInception blocks are ``Branches`` nodes whose b0/b1/b2
    entry convs share the block-input site. BN eps is 1e-3 (the
    torchvision S3D value), folded via Conv.bn_eps. Head: gap_t2 (f32
    spatial mean, temporal window-2 stride-1 mean, temporal mean) —
    models/s3d.py head note.

    ``gating=True`` (S3D-G): every separable conv's temporal factor
    carries the per-channel self-gate (Conv.gate -> the SepConv's Dense
    params); the engines run it as an f32 epilogue after the requant
    affine — data-dependent, exactly like the dynamic amax pass the int8
    engine already performs per site.
    """
    EPS = 1e-3

    def sep(key_prefix, path, s=1):
        """SepConv: spatial (1,s,s) + bn_s, temporal (s,1,1) + bn_t
        (+ the S3D-G self-gate on the temporal output when gating)."""
        return (
            Conv(f"{key_prefix}.s_in", tuple(path) + ("spatial", "kernel"),
                 (1, s, s), bn=tuple(path) + ("bn_s",), bn_eps=EPS),
            Conv(f"{key_prefix}.t_in", tuple(path) + ("temporal", "kernel"),
                 (s, 1, 1), bn=tuple(path) + ("bn_t",), bn_eps=EPS,
                 gate=tuple(path) + ("gate",) if gating else None),
        )

    def inception(name):
        b0 = (Conv(f"{name}.in", (name, "b0", "kernel"), (1, 1, 1),
                   bn=(name, "b0_bn"), bn_eps=EPS),)
        b1 = (Conv(f"{name}.in", (name, "b1_reduce", "kernel"), (1, 1, 1),
                   bn=(name, "b1_bn"), bn_eps=EPS),
              *sep(f"{name}.b1", (name, "b1_sep")))
        b2 = (Conv(f"{name}.in", (name, "b2_reduce", "kernel"), (1, 1, 1),
                   bn=(name, "b2_bn"), bn_eps=EPS),
              *sep(f"{name}.b2", (name, "b2_sep")))
        b3 = (MaxPool((3, 3, 3), (1, 1, 1),
                      padding=((1, 1), (1, 1), (1, 1))),
              Conv(f"{name}.pool", (name, "b3_conv", "kernel"), (1, 1, 1),
                   bn=(name, "b3_bn"), bn_eps=EPS))
        return Branches((b0, b1, b2, b3))

    nodes = [
        *sep("stem", ("stem",), s=2),
        MaxPool((1, 3, 3), (1, 2, 2), padding=((0, 0), (1, 1), (1, 1))),
        Conv("pool1", ("conv2", "kernel"), (1, 1, 1), bn=("conv2_bn",),
             bn_eps=EPS),
        *sep("conv3", ("conv3",)),
        MaxPool((1, 3, 3), (1, 2, 2), padding=((0, 0), (1, 1), (1, 1))),
        inception("mixed3b"),
        inception("mixed3c"),
        MaxPool((3, 3, 3), (2, 2, 2), padding=((1, 1), (1, 1), (1, 1))),
        inception("mixed4b"),
        inception("mixed4c"),
        inception("mixed4d"),
        inception("mixed4e"),
        inception("mixed4f"),
        MaxPool((2, 2, 2), (2, 2, 2)),
        inception("mixed5b"),
        inception("mixed5c"),
    ]
    # No residual structure -> no cancellation-amplified tail; every conv
    # quantizes. Scheme history, all measured on a trained model: global
    # static margin 2.0 drifts on branch sites (-3pp, INT8_S3D.json);
    # round 3 defaulted to dynamic for parity (0.96) at a 23% throughput
    # cost (5163 vs 6704 clips/s B=32 — the amax pass writes bf16 and
    # re-reads twice instead of the 1-byte epilogue). Round 4's
    # branch-site-aware static margins recover to 0.95 (within the 2pp
    # serving gate) AT static speed, so they are the default; dynamic=True
    # remains the exact-parity option (INT8_INCEPTION.json).
    return ArchSpec(tuple(nodes), "gap_t2", (Dense(("fc",)),),
                    default_site_margins=True)


def i3d_spec() -> ArchSpec:
    """I3D (models/i3d.py, pytorch-i3d geometry). The full-3D sibling of
    s3d_spec: same Branches topology and widths with single kxkxk branch
    convs, BN eps 1e-3, gap_t2 head. The stem conv and the stride-2
    maxpools carry TF-SAME padding ('same_tf'/'SAME_TF', resolved from
    the traced shape); every stride-1 odd-k conv's TF-SAME equals the
    default symmetric k//2."""
    EPS = 1e-3

    def unit(site, path, k_strides=(1, 1, 1), padding=None):
        return Conv(site, tuple(path) + ("conv", "kernel"), k_strides,
                    bn=tuple(path) + ("bn",), bn_eps=EPS, padding=padding)

    def inception(name):
        b0 = (unit(f"{name}.in", (name, "b0")),)
        b1 = (unit(f"{name}.in", (name, "b1_reduce")),
              unit(f"{name}.b1", (name, "b1_conv")))
        b2 = (unit(f"{name}.in", (name, "b2_reduce")),
              unit(f"{name}.b2", (name, "b2_conv")))
        b3 = (MaxPool((3, 3, 3), (1, 1, 1), padding="SAME_TF"),
              unit(f"{name}.pool", (name, "b3_conv")))
        return Branches((b0, b1, b2, b3))

    nodes = [
        unit("input", ("conv1",), (2, 2, 2), padding="same_tf"),
        MaxPool((1, 3, 3), (1, 2, 2), padding="SAME_TF"),
        unit("pool1", ("conv2",)),
        unit("conv2.out", ("conv3",)),
        MaxPool((1, 3, 3), (1, 2, 2), padding="SAME_TF"),
        inception("mixed3b"),
        inception("mixed3c"),
        MaxPool((3, 3, 3), (2, 2, 2), padding="SAME_TF"),
        inception("mixed4b"),
        inception("mixed4c"),
        inception("mixed4d"),
        inception("mixed4e"),
        inception("mixed4f"),
        MaxPool((2, 2, 2), (2, 2, 2), padding="SAME_TF"),
        inception("mixed5b"),
        inception("mixed5c"),
    ]
    # No residual structure (same as s3d). default_dynamic is MEASURED for
    # this family (INT8_INCEPTION.json; round-5 margin sweep, replacing
    # round 3's s3d analogy): dynamic is exact bf16 parity (0.965 ==
    # 0.965) while EVERY static scheme loses >= 2pp — the sweep is
    # steeply monotone in margin (1.0 -> 0.61, 1.5 -> 0.825, 2.5 ->
    # 0.945), i.e. i3d is activation-headroom-bound like s3d but
    # steeper, and no static margin reaches parity. The round-4
    # "site-static (0.925) under global (0.93)" inversion was ONE
    # video of eval noise on that steep curve: round 5 re-measures site
    # 0.94 > global 0.915, the order the site margins (median 2.24 vs
    # 2.0) predict. Static-vs-dynamic THROUGHPUT is a coin flip inside
    # run variance on the compute-bound dense-3D walk (r4: dyn 4310 >
    # static 4058; r5: static 4114 > dyn 3979; both ~1.2x bf16) — the
    # amax pass hides under MXU time, so accuracy decides the default.
    return ArchSpec(tuple(nodes), "gap_t2", (Dense(("fc",)),),
                    default_dynamic=True)


def slowfast_spec(alpha: int = 4, beta: int = 8, base_width: int = 64,
                  stage_blocks: Tuple[int, ...] = (1, 1, 1, 1),
                  pack_fast: bool = False) -> ArchSpec:
    """SlowFast dual-pathway net (models/slowfast.py, zoo defaults).

    Two streams over the input: ``slow`` = x[:, ::alpha] through wide
    blocks, ``fast`` = full rate through 1/beta-width blocks; a lateral
    (5x1x1, stride alpha) conv projects fast -> 2*C_fast channels and
    concatenates into slow after the stem and after every stage. Head:
    gap both streams, concat (slow first — the flax concat order), fc.

    ``pack_fast=True`` is `slowfast_r2plus1d_tpu`: the fast stream is
    time-to-channel packed (Subsample.pack=alpha) so both streams share
    the time axis and the laterals are stride-free 3x1x1 convs — widths
    change but the walk topology is identical (models/slowfast.py).

    Site sharing: the fast tensor at each fusion point feeds BOTH the
    lateral conv and the next fast block's entry — one site name, so the
    smoothing-consumers map sees both kernels. SFBlock downsample convs
    exist when stride != 1 OR cin != features (the channel arithmetic
    below mirrors the flax module: slow cin grows by 2*wf per fusion).
    """
    cf = max(base_width // beta, 8)
    lat_stride = (1, 1, 1) if pack_fast else (alpha, 1, 1)

    def lateral(idx: int, site: str) -> Fuse:
        return Fuse("fast", "slow",
                    Conv(site, (f"lateral{idx}", "kernel"), lat_stride,
                         bn=(f"lateral{idx}_bn",)))

    def sf_block(key: str, s: int, cin: int, feats: int) -> Block:
        main = (
            Conv(f"{key}.in", (key, "spatial1", "kernel"), (1, s, s),
                 bn=(key, "bn1")),
            Conv(f"{key}.s1", (key, "temporal1", "kernel"), (1, 1, 1),
                 bn=(key, "bn2")),
            Conv(f"{key}.t1", (key, "spatial2", "kernel"), (1, 1, 1),
                 bn=(key, "bn3"), relu=False),
        )
        down = (Conv(f"{key}.in", (key, "down", "kernel"), (1, s, s),
                     bn=(key, "bn_down"), relu=False)
                if (s != 1 or cin != feats) else None)
        return Block(key, main, down)

    fmul = alpha if pack_fast else 1
    nodes = [
        Subsample("x", "slow", alpha),
        Subsample("x", "fast", 1, pack=fmul),
        Stream("slow", (Conv("slow.in", ("slow_stem", "kernel"), (1, 2, 2),
                             bn=("slow_stem_bn",)),)),
        Stream("fast", (Conv("fast.in", ("fast_stem", "kernel"), (1, 2, 2),
                             bn=("fast_stem_bn",)),)),
        lateral(0, "fast_s0_b0.in"),
    ]
    slow_c, fast_c = base_width + 2 * cf, cf * fmul
    for stage, num_blocks in enumerate(stage_blocks):
        ws = base_width * (2 ** stage)
        # fast blocks carry fmul x channels when packed; the LATERAL still
        # projects to 2 * the UNPACKED width, so the slow trunk's channel
        # arithmetic is identical in both variants (models/slowfast.py)
        wf_u = max(ws // beta, 8)
        wf = wf_u * fmul
        slow_blocks, fast_blocks = [], []
        for b in range(num_blocks):
            s = 2 if (stage > 0 and b == 0) else 1
            slow_blocks.append(
                sf_block(f"slow_s{stage}_b{b}", s, slow_c, ws))
            fast_blocks.append(
                sf_block(f"fast_s{stage}_b{b}", s, fast_c, wf))
            slow_c, fast_c = ws, wf
        nodes.append(Stream("slow", tuple(slow_blocks)))
        nodes.append(Stream("fast", tuple(fast_blocks)))
        last = stage == len(stage_blocks) - 1
        nodes.append(lateral(stage + 1, "fast.out" if last
                             else f"fast_s{stage + 1}_b0.in"))
        slow_c = ws + 2 * wf_u
    # bf16 tail by analogy with the measured r2plus1d register (the final
    # widest-stage residual blocks sit behind the same main-path/residual
    # cancellation); pending on-chip accuracy measurement for this family.
    last_stage = len(stage_blocks) - 1
    tail = tuple(f"{p}_s{last_stage}_b{b}"
                 for p in ("slow", "fast")
                 for b in range(stage_blocks[last_stage]))
    return ArchSpec(tuple(nodes), "gap", (Dense(("fc",)),),
                    default_float_blocks=tail,
                    head_streams=("slow", "fast"))


# zoo name -> spec builder (the serving-surface gate; replaces the round-2
# STAGE_BLOCKS dict). `_tpu` variants share the faithful structure.
_BUILDERS = {
    "r2plus1d_18": lambda: r2plus1d_spec((2, 2, 2, 2)),
    "r2plus1d_18_tpu": lambda: r2plus1d_spec((2, 2, 2, 2)),
    "r2plus1d_34": lambda: r2plus1d_spec((3, 4, 6, 3)),
    "r2plus1d_34_tpu": lambda: r2plus1d_spec((3, 4, 6, 3)),
    "p3d_63": lambda: p3d_spec((3, 4, 6, 3)),
    "p3d_131": lambda: p3d_spec((3, 4, 23, 3)),
    "p3d_199": lambda: p3d_spec((3, 8, 36, 3)),
    "c3d": c3d_spec,
    "r3d_18": lambda: videoresnet_spec(("3d",) * 4),
    "mc3_18": lambda: videoresnet_spec(("3d", "no_t", "no_t", "no_t")),
    "slowfast_r2plus1d": slowfast_spec,
    "slowfast_r2plus1d_tpu": lambda: slowfast_spec(pack_fast=True),
    "s3d": s3d_spec,
    "s3d_g": lambda: s3d_spec(gating=True),
    "i3d": i3d_spec,
}

# Every surface gating on engine coverage (Tagger, quantized glue, serving
# export) derives from the one builders dict — the gates cannot drift.
COVERED_MODELS = tuple(sorted(_BUILDERS))


def spec_for(model_name: str) -> ArchSpec:
    if model_name not in _BUILDERS:
        raise KeyError(
            f"serving/int8 engine covers {sorted(_BUILDERS)}; "
            f"got {model_name!r}")
    return _BUILDERS[model_name]()


# ---------------------------------------------------------------------------
# Spec paths -> the port's state_dict (the rule of models/convert.py)
# ---------------------------------------------------------------------------


def param_key(path: Tuple[str, ...]) -> str:
    """The port's state_dict key of a spec path: joined with ``.``, the
    norm wrapper's ``BatchNorm_0`` level dropped, a Dense ``kernel`` named
    ``weight`` (stored transposed, see ``param``)."""
    names = [p for p in path if p != "BatchNorm_0"]
    return ".".join(names)


def param(state_dict, path: Tuple[str, ...]):
    """The tensor at a spec path, in the JAX layout: conv kernels and
    biases as stored; a Dense ``(prefix, "kernel")`` is the port's
    ``prefix.weight`` (Cout, Cin) transposed to (Cin, Cout)."""
    key = param_key(path)
    if key in state_dict:
        return state_dict[key]
    if path and path[-1] == "kernel":
        prefix = param_key(path[:-1])
        weight = state_dict.get(f"{prefix}.weight")
        if weight is not None and weight.ndim == 2:
            return weight.T
    raise KeyError(f"no tensor for spec path {'/'.join(path)} (state_dict key {key!r})")
