"""The tensor-core kernels (A ``q4_lut_post``, B ``q4_lut_fused``, C
``q4_int4_magic``, E ``q4_lut_select``, ``int8_post``, ``int8_fused``, D
``w4a8``, ``w8a8`` and their fused twins ``w4a8_fused`` and
``w8a8_fused``) at the shapes their tiles make ragged, and their launch
plan, on the CPU.

- The plain versions, which the wrapper runs on CPU tensors and which the
  CUDA kernels are held against on the card, against the JAX package's
  interpreted ``_q4t_kernel`` (any4/nf4/fp4), ``_q4pair_kernel`` (int4p),
  ``_int8q_kernel`` and ``_int8t_kernel`` at m in {8, 17, 130} (a full n8
  token tile, one past two, one past a 64-token block), n not a multiple
  of 16 (the rows of one warp's mma tile) and g in {128, 256} (for C and
  ``int8_post`` two 128-wide slices fold with one group's scale), float32
  output within 1e-4 * max (only the order of the f32 sums differs).
- The same for D and ``w8a8`` on int8 x from the JAX package's
  ``quantize_activations``, against the interpreted ``_w4a8_kernel``,
  ``_w8a8_kernel`` (row layout), ``_w8a8q_kernel`` and ``_w8a8t_kernel``
  at m in {8, 17, 130, 1024} (1024: the W4A8/W8A8 prefill's chunk), n in
  {24, 200} and g in {128, 256}, within 1e-5 * max (their integer dots are
  exact).
- The same for ``w4a8_fused`` and ``w8a8_fused`` on float x (bf16 and f32)
  against the interpreted ``_w4a8f_kernel``, ``_w8a8f_kernel``,
  ``_w8a8qf_kernel`` and ``_w8a8tf_kernel`` (the kernels that quantize
  x themselves), at m in {1, 8, 9, 17, 33, 64} (the decode body, one past
  it, and the 16-, 32- and 64-token tiles of the block body up to
  ``FUSED_ACT_M_MAX``), within 1e-5 * max of the f32 output, and against
  the JAX package's external path (its ``quantize_activations``, the
  interpreted external kernel, ``* sx``). Interpreted on the CPU, XLA
  computes the fused JAX kernels' ``max|x| / 127`` as ``max|x| * (1 /
  127)``, one ulp off ``quantize_activations``' scale in some rows (where
  x / sx lies near a half, that moves a code); those rows are held against
  the external path alone.
- The same for B's and E's plain versions against the interpreted
  ``_q4_kernel`` (any4 at g in {16, 32, 64}, row-layout int4 at g in {128,
  256}) and ``_q4select_kernel`` (``use_gather=False``: row-layout any4
  and int4 at g in {128, 256}), and for ``int8_fused``'s against the
  interpreted ``_int8_kernel`` (``int8`` at g in {16, 32, 64}, row layout
  at g in {128, 256}), at m in {1, 8, 9, 17, 130}, n in {24, 200} and k
  in {1024, 2048}, within 1e-4 * max of the f32 output.
- ``gemv.kernel_a_plan``: the split of k depends on (n, num_groups, sms)
  and never on m, so that a token's sums run in the same order at every m;
  the token tiles, row blocks and splits cover (m, n, k) exactly, with no
  empty split; each split gets a block of its own only where the tiles
  alone leave SMs idle. C, ``int8_post``, D and ``w8a8`` call it with
  their slice count as ``num_groups``, which the same cases cover; D's and
  ``w8a8``'s 1B shapes also at the m of their prefill, up to 1024.
- ``gemv.post_launch_plan``, which every tensor-core launch goes through:
  at the 1B shapes a fused kernel gets its external twin's plan at every
  m <= 64, so that it runs the same bodies in the same order, and room
  for its quantized x beside the split scratch; B, E and ``int8_fused``
  take the same plan at every m, over ``ceil(G g / 128)`` slices (a g that
  does not divide 128 included), split alike at every m, with tiles and
  splits that cover (m, n, k).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.ops import linear as jlin
from any4_tpu.ops.pallas import gemv as jgemv
from any4_tpu_torch.ops import gemv, linear as tlin, packing
from test_torch_convert import assert_close_max
from test_torch_gemv import _jax_mm, _pair

# (fmt, g, n, k, m)
TAILS = [
    ("any4", 128, 40, 2048, 8),
    ("any4", 256, 200, 1024, 17),
    ("any4", 128, 24, 2048, 130),
    ("any4", 256, 72, 2048, 130),
    ("nf4", 256, 24, 1024, 8),
    ("fp4", 128, 200, 1024, 17),
    ("int4", 128, 24, 2048, 8),
    ("int4", 256, 200, 1024, 17),
    ("int4", 128, 200, 2048, 130),
    ("int4", 256, 24, 2048, 130),
    ("int8q", 128, 200, 1024, 8),
    ("int8q", 256, 24, 2048, 17),
    ("int8q", 128, 24, 2048, 130),
    ("int8t", 256, 200, 1024, 8),
    ("int8t", 128, 24, 1024, 17),
    ("int8t", 256, 200, 2048, 130),
]
# the weight format each one quantizes to, and the port kernel it runs
KERNEL_OF = {"any4": ("any4t", "q4_lut_post"), "nf4": ("nf4t", "q4_lut_post"),
             "fp4": ("fp4t", "q4_lut_post"), "int4": ("int4p", "q4_int4_magic"),
             "int8q": ("int8q", "int8_post"), "int8t": ("int8t", "int8_post")}


@pytest.mark.parametrize("fmt,g,n,k,m", TAILS,
                         ids=[f"{f}-g{g}-n{n}-k{k}-m{m}"
                              for f, g, n, k, m in TAILS])
def test_plain_matches_jax_kernel_at_tails(fmt, g, n, k, m, monkeypatch):
    jqt, qt = _pair(fmt, g, None, n, k, seed=m)
    weight_fmt, kernel = KERNEL_OF[fmt]
    assert qt.fmt == weight_fmt and qt.group_size == g
    x = np.random.default_rng(k + m).standard_normal((m, k)).astype(
        np.float32)
    plain = getattr(gemv, kernel + "_plain")
    called = []
    monkeypatch.setattr(gemv, kernel + "_plain",
                        lambda *a: called.append(1) or plain(*a))
    before = dict(gemv.LAUNCHES)
    y = gemv.quantized_matmul(
        torch.from_numpy(x), qt.packed, qt.scales, qt.zeros, qt.lut,
        group_size=g, out_dtype=torch.float32,
        fmt=tlin._kernel_fmt(qt.fmt, qt.lut))
    assert called == [1]                # the plain version of that kernel
    assert gemv.LAUNCHES == before      # CPU tensors launch nothing
    assert y.shape == (m, n) and y.dtype == torch.float32
    assert_close_max(y, _jax_mm(x, jqt), 1e-4)


# (fmt, layout, g, n, k, m): D and the three W8A8 TPU layouts on int8 x
A8_TAILS = [
    ("w4a8", None, 128, 24, 2048, 8),
    ("w4a8", None, 256, 200, 1024, 17),
    ("w4a8", None, 128, 200, 2048, 130),
    ("w4a8", None, 256, 24, 1024, 1024),
    ("w8a8", "row", 128, 200, 1024, 8),
    ("w8a8", "row", 256, 24, 2048, 130),
    ("w8a8", "row", 128, 24, 1024, 1024),
    ("w8a8q", None, 256, 24, 2048, 17),
    ("w8a8q", None, 128, 200, 1024, 130),
    ("w8a8q", None, 256, 200, 1024, 1024),
    ("w8a8t", None, 128, 200, 2048, 8),
    ("w8a8t", None, 256, 24, 1024, 17),
    ("w8a8t", None, 128, 200, 1024, 1024),
]


@pytest.mark.parametrize("fmt,layout,g,n,k,m", A8_TAILS,
                         ids=[f"{f}-g{g}-n{n}-k{k}-m{m}"
                              for f, _, g, n, k, m in A8_TAILS])
def test_a8_plain_matches_jax_kernel_at_tails(fmt, layout, g, n, k, m,
                                              monkeypatch):
    """int8 x through ``quantized_matmul`` runs D's or ``w8a8``'s plain
    version, which holds the f32 sum before ``* sx`` of the JAX kernel of
    that layout."""
    jqt, qt = _pair(fmt, g, layout, n, k, seed=m)
    kernel = "w4a8" if fmt == "w4a8" else "w8a8"
    assert qt.fmt == jqt.fmt == fmt and qt.group_size == g
    x = np.random.default_rng(k + m).standard_normal((m, k)).astype(
        np.float32)
    xq = np.array(jlin.quantize_activations(jnp.asarray(x))[0])
    assert xq.dtype == np.int8
    plain = getattr(gemv, kernel + "_plain")
    called = []
    monkeypatch.setattr(gemv, kernel + "_plain",
                        lambda *a: called.append(1) or plain(*a))
    before = dict(gemv.LAUNCHES)
    y = gemv.quantized_matmul(
        torch.from_numpy(xq), qt.packed, qt.scales, qt.zeros,
        group_size=g, out_dtype=torch.float32, fmt=tlin._kernel_fmt(qt.fmt))
    assert called == [1]                # the plain version of that kernel
    assert gemv.LAUNCHES == before      # CPU tensors launch nothing
    assert y.shape == (m, n) and y.dtype == torch.float32
    assert_close_max(y, _jax_mm(xq, jqt), 1e-5)


# (fmt, layout, g, n, k, m): the fused kernels on float x, m <= 64
A8F_TAILS = [
    ("w4a8", None, 128, 24, 2048, 1),
    ("w4a8", None, 256, 200, 1024, 8),
    ("w4a8", None, 128, 200, 1024, 9),
    ("w4a8", None, 256, 24, 2048, 17),
    ("w4a8", None, 128, 200, 2048, 33),
    ("w4a8", None, 256, 24, 1024, 64),
    ("w8a8", "row", 256, 200, 1024, 1),
    ("w8a8", "row", 128, 24, 2048, 9),
    ("w8a8", "row", 256, 200, 2048, 64),
    ("w8a8q", None, 128, 200, 2048, 8),
    ("w8a8q", None, 256, 24, 1024, 17),
    ("w8a8q", None, 128, 24, 1024, 33),
    ("w8a8t", None, 128, 24, 1024, 1),
    ("w8a8t", None, 256, 200, 2048, 9),
    ("w8a8t", None, 128, 200, 1024, 64),
]


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fmt,layout,g,n,k,m", A8F_TAILS,
                         ids=[f"{f}-g{g}-n{n}-k{k}-m{m}"
                              for f, _, g, n, k, m in A8F_TAILS])
def test_a8_fused_plain_matches_jax_kernel_at_tails(fmt, layout, g, n, k, m,
                                                    x_dtype, monkeypatch):
    """Float x through ``quantized_matmul`` runs ``w4a8_fused``'s or
    ``w8a8_fused``'s plain version, which holds the JAX package's external
    path and the JAX kernel of that layout that quantizes x itself, on the
    same bf16 or f32 values (the latter on the rows where its interpreted
    scale is ``quantize_activations``')."""
    jqt, qt = _pair(fmt, g, layout, n, k, seed=m + 1)
    kernel = "w4a8_fused" if fmt == "w4a8" else "w8a8_fused"
    assert qt.fmt == jqt.fmt == fmt and qt.group_size == g
    x = torch.from_numpy(np.random.default_rng(k + m + 1).standard_normal(
        (m, k)).astype(np.float32) * 3).to(getattr(torch, x_dtype))
    plain = getattr(gemv, kernel + "_plain")
    called = []
    monkeypatch.setattr(gemv, kernel + "_plain",
                        lambda *a: called.append(1) or plain(*a))
    before = dict(gemv.LAUNCHES)
    y = gemv.quantized_matmul(
        x, qt.packed, qt.scales, qt.zeros, group_size=g,
        out_dtype=torch.float32, fmt=tlin._kernel_fmt(qt.fmt))
    assert called == [1]                # the plain version of that kernel
    assert gemv.LAUNCHES == before      # CPU tensors launch nothing
    assert y.shape == (m, n) and y.dtype == torch.float32
    xj = jnp.asarray(x.float().numpy()).astype(getattr(jnp, x_dtype))
    xq, sx = jlin.quantize_activations(xj)
    assert_close_max(y, _jax_mm(xq, jqt) * np.asarray(sx), 1e-5)
    amax = np.maximum(np.abs(x.float().numpy()).max(axis=1), np.float32(1e-8))
    same = amax * (np.float32(1) / np.float32(127)) == np.asarray(sx)[:, 0]
    assert same.sum() >= m // 2
    assert_close_max(y[same], _jax_mm(xj, jqt)[same], 1e-5)


SHAPES = [(n, G) for n in (1, 24, 64, 200, 512, 1000, 2048, 8192)
          for G in (1, 2, 8, 16, 64)]
PLAN_MS = (1, 3, 8, 9, 16, 17, 32, 33, 64, 130, 512, 4096)
# D's and w8a8's 1B linears (n, 128-k slices: 16 at k = 2048, 64 at 8192)
# at the m of their prefill, up to the 1024-row chunk
A8_PLAN_MS = (1, 8, 9, 16, 17, 64, 65, 128, 129, 512, 513, 1000, 1024)
PLAN_CASES = [(n, G, PLAN_MS) for n, G in SHAPES] + [
    (n, G, A8_PLAN_MS) for n, G in ((2048, 16), (512, 16), (8192, 16),
                                    (2048, 64))]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n,G,ms", PLAN_CASES,
                         ids=[f"{n}-{G}" if ms is PLAN_MS else f"a8-{n}-{G}"
                              for n, G, ms in PLAN_CASES])
def test_plan_splits_k_alike_at_every_m(n, G, ms, sms):
    plans = {m: gemv.kernel_a_plan(m, n, G, sms) for m in ms}
    assert len({p[1:3] for p in plans.values()}) == 1
    for m, (tn, splits, per, split_blocks) in plans.items():
        assert tn in (1, 2, 4, 8)
        assert tn == 8 or 8 * tn >= m               # the fewest tiles
        assert tn == 1 or 4 * tn < m                # that hold m
        blocks = -(-m // (8 * tn))
        assert (blocks - 1) * 8 * tn < m <= blocks * 8 * tn
        assert per >= 1 and (splits - 1) * per < G <= splits * per
        row_blocks = -(-n // gemv.A_ROWS)
        assert (row_blocks - 1) * gemv.A_ROWS < n <= row_blocks * gemv.A_ROWS
        # one block per split only where the tiles leave SMs idle, never in
        # the decode body, whose warps share a tile's splits
        assert split_blocks == (1 if tn == 1 or blocks * row_blocks >= sms
                                else splits)


def test_plan_fills_the_card():
    """The decode body gets about 16 warps per SM, one split each: k/v_proj
    of the 1B model (n=512, 16 groups) and q/o_proj (n=2048) take one group
    a split, gate/up_proj (n=8192, 512 row tiles of 16) four."""
    assert gemv.kernel_a_plan(1, 512, 16, 132) == (1, 16, 1, 1)
    assert gemv.kernel_a_plan(16, 512, 16, 132) == (2, 16, 1, 16)
    assert gemv.kernel_a_plan(1, 2048, 16, 132) == (1, 16, 1, 1)
    assert gemv.kernel_a_plan(1, 2048, 64, 132) == (1, 16, 4, 1)
    assert gemv.kernel_a_plan(1, 8192, 16, 132) == (1, 4, 4, 1)
    # a 512-row prefill chunk: 128 x 8 tiles, each block sums its splits
    assert gemv.kernel_a_plan(512, 8192, 16, 132) == (8, 4, 4, 1)
    assert gemv.kernel_a_plan(512, 8192, 2, 1) == (8, 1, 2, 1)


# the 1B linears (n, k) that the fused kernels serve
A8F_PLAN_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n,k", A8F_PLAN_SHAPES,
                         ids=[f"{n}x{k}" for n, k in A8F_PLAN_SHAPES])
def test_fused_takes_the_external_plan(n, k, sms):
    """At every m up to ``FUSED_ACT_M_MAX`` a fused kernel launches with its
    external twin's token tiles, k splits and split blocks (so the bits of
    ``fused(x)`` are those of ``external(xq) * sx``), the same ticket
    counters, and scratch for the split partials plus its pre-pass's
    ``sx`` and ``xq``."""
    G = k // 128
    for m in range(1, gemv.FUSED_ACT_M_MAX + 1):
        for fused, ext in (("w4a8_fused", "w4a8"), ("w8a8_fused", "w8a8")):
            f = gemv.post_launch_plan(fused, m, n, k, G, 128, sms)
            e = gemv.post_launch_plan(ext, m, n, k, G, 128, sms)
            assert f[:3] == e[:3] and f[4] == e[4]
            tn, per, split_blocks = e[:3]
            assert (tn, -(-G // per), per) == gemv.kernel_a_plan(
                m, n, G, sms)[:3]
            assert f[3] == e[3] + -(-m // 4) * 4 + m * k // 4
            tiles = -(-n // gemv.A_ROWS) * -(-m // (8 * tn))
            assert e[3] == (0 if split_blocks == 1 else
                            -(-G // per) * tiles * 8 * tn * gemv.A_ROWS)


# (fmt, layout, g, n, k, m, use_gather): kernel B (``_q4_kernel``) with
# use_gather, kernel E (``_q4select_kernel``) without; int8 runs
# ``int8_fused`` (``_int8_kernel``) either way
LUT_TAILS = [
    ("any4", None, 16, 24, 1024, 1, True),
    ("any4", None, 16, 200, 2048, 9, True),
    ("any4", None, 16, 24, 2048, 130, True),
    ("any4", None, 32, 200, 1024, 8, True),
    ("any4", None, 32, 24, 2048, 17, True),
    ("any4", None, 32, 200, 1024, 130, True),
    ("any4", None, 64, 24, 2048, 1, True),
    ("any4", None, 64, 200, 1024, 9, True),
    ("any4", None, 64, 24, 1024, 17, True),
    ("any4", None, 64, 200, 2048, 130, True),
    ("int4", "row", 128, 24, 2048, 8, True),
    ("int4", "row", 256, 200, 1024, 130, True),
    ("any4", "row", 128, 200, 2048, 1, False),
    ("any4", "row", 256, 24, 1024, 17, False),
    ("int4", "row", 128, 200, 1024, 130, False),
    ("int4", "row", 256, 24, 2048, 9, False),
    ("int8", None, 16, 24, 1024, 1, True),
    ("int8", None, 16, 200, 2048, 9, True),
    ("int8", None, 16, 24, 2048, 17, True),
    ("int8", None, 16, 200, 1024, 130, True),
    ("int8", None, 32, 200, 1024, 1, True),
    ("int8", None, 32, 24, 2048, 9, True),
    ("int8", None, 32, 200, 2048, 17, True),
    ("int8", None, 32, 24, 1024, 130, True),
    ("int8", None, 64, 24, 2048, 1, True),
    ("int8", None, 64, 200, 1024, 9, True),
    ("int8", None, 64, 24, 1024, 17, True),
    ("int8", None, 64, 200, 2048, 130, True),
    ("int8", "row", 128, 200, 2048, 1, True),
    ("int8", "row", 128, 24, 1024, 9, True),
    ("int8", "row", 128, 200, 1024, 17, True),
    ("int8", "row", 128, 24, 2048, 130, True),
    ("int8", "row", 256, 24, 1024, 1, True),
    ("int8", "row", 256, 200, 2048, 9, True),
    ("int8", "row", 256, 24, 2048, 17, True),
    ("int8", "row", 256, 200, 1024, 130, True),
]


@pytest.mark.parametrize("fmt,layout,g,n,k,m,use_gather", LUT_TAILS,
                         ids=[f"{f}-{l or 'default'}-g{g}-n{n}-k{k}-m{m}-"
                              f"{'fused' if f == 'int8' else 'gather' if u else 'select'}"
                              for f, l, g, n, k, m, u in LUT_TAILS])
def test_fused_lut_plain_matches_jax_kernel_at_tails(fmt, layout, g, n, k, m,
                                                     use_gather,
                                                     monkeypatch):
    """``quantized_matmul`` runs kernel B's plain version (any4 below g=128,
    row-layout int4 with the ramp LUT) or, with ``use_gather=False``, kernel
    E's, or for row-layout int8 ``int8_fused``'s, which hold the
    interpreted JAX kernel of that route."""
    jqt, qt = _pair(fmt, g, layout, n, k, seed=m + g)
    kernel = ("int8_fused" if fmt == "int8" else
              "q4_lut_fused" if use_gather else "q4_lut_select")
    assert qt.fmt == jqt.fmt == fmt and qt.group_size == g
    x = np.random.default_rng(k + m + g).standard_normal((m, k)).astype(
        np.float32)
    plain = getattr(gemv, kernel + "_plain")
    called = []
    monkeypatch.setattr(gemv, kernel + "_plain",
                        lambda *a: called.append(1) or plain(*a))
    before = dict(gemv.LAUNCHES)
    y = gemv.quantized_matmul(
        torch.from_numpy(x), qt.packed, qt.scales, qt.zeros, qt.lut,
        group_size=g, out_dtype=torch.float32,
        fmt=tlin._kernel_fmt(qt.fmt, qt.lut), use_gather=use_gather)
    assert called == [1]                # the plain version of that kernel
    assert gemv.LAUNCHES == before      # CPU tensors launch nothing
    assert y.shape == (m, n) and y.dtype == torch.float32
    ref = np.asarray(jgemv.quantized_matmul(
        jnp.asarray(x), jqt.packed, jqt.scales, jqt.zeros, jqt.lut,
        fmt=jlin._kernel_fmt(jqt.fmt, jqt.lut), group_size=g, n=n,
        interpret=True, out_dtype=jnp.float32, use_gather=use_gather))
    assert_close_max(y, ref, 1e-4)


# B's group sizes, 128's divisors and multiples and some that are neither,
# and int8_fused's (16 or more, dividing 128 or a multiple of it)
LUT_PLAN_GS = (8, 16, 24, 48, 64, 128, 256)
LUT_PLAN_CASES = [("q4_lut_fused", g) for g in LUT_PLAN_GS] + [
    ("int8_fused", g) for g in (16, 32, 64, 128, 256)]
LUT_PLAN_SHAPES = [(24, 1024), (200, 2048), (2048, 2048), (512, 2048),
                   (8192, 2048), (2048, 8192)]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("name,g", LUT_PLAN_CASES,
                         ids=[str(g) if name == "q4_lut_fused" else
                              f"{name}-{g}" for name, g in LUT_PLAN_CASES])
@pytest.mark.parametrize("n,k", LUT_PLAN_SHAPES,
                         ids=[f"{n}x{k}" for n, k in LUT_PLAN_SHAPES])
def test_fused_lut_plan(n, k, name, g, sms):
    """B, E and ``int8_fused`` launch with one plan at every m (so E = B
    bit for bit), over ``ceil(G g / 128)`` 128-wide slices, where ``G = kp
    // g`` groups may end short of kp; the split of the slices is the same
    at every m; the token tiles, row blocks and splits cover (m, n, k)
    exactly, and the scratch and tickets match the split blocks."""
    G = packing.padded_k(k) // g
    slices = -(-G * g // gemv.SLICE)
    if gemv.SLICE % g and g % gemv.SLICE:
        assert slices * gemv.SLICE > G * g          # the floor would drop one
    splits_at = set()
    for m in PLAN_MS:
        b = gemv.post_launch_plan(name, m, n, k, G, g, sms)
        for twin in ("q4_lut_fused", "q4_lut_select"):         # B's plan
            assert gemv.post_launch_plan(twin, m, n, k, G, g, sms) == b
        tn, per, split_blocks, floats, ints = b
        splits = -(-slices // per)
        assert (tn, splits, per, split_blocks) == gemv.kernel_a_plan(
            m, n, slices, sms)
        assert per >= 1 and (splits - 1) * per < slices <= splits * per
        splits_at.add((splits, per))
        tiles = -(-n // gemv.A_ROWS) * -(-m // (8 * tn))
        assert (-(-m // (8 * tn)) - 1) * 8 * tn < m <= -(-m // (8 * tn)) \
            * 8 * tn
        assert floats == (splits * tiles * 8 * tn * gemv.A_ROWS
                          if split_blocks > 1 else 0)
        assert ints == (tiles if split_blocks > 1 else 0)
    assert len(splits_at) == 1
