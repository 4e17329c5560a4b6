"""The port at the narrow widths of the width matrix
(``neurovit_tpu_torch.models.vit3d.WIDTHS``) against the JAX package, and
what makes every width of the matrix run on the card, checked without one:

- the model (depth 2, 9 tokens), block 0, and each fused op at the hd32
  (dim 256, 8 heads of 32, MLP 512) and hd80 (320, 4 x 80, 640) widths, and
  block 0 at the smoke width (64, 4 x 16, 128), on weights carried by
  ``from_jax_params``, against JAX's ``pallas`` impl (the Pallas kernels in
  interpret mode) and its ``xla`` impl; f32 rtol = atol = 1e-3, bf16 atol
  5e-2 (the tolerances of tests/test_torch_vit3d.py). The model and the ops
  at the smoke width are tests/test_torch_vit3d.py's and
  tests/test_torch_ops.py's;
- the attention's zero-padding of the head dim to the kernels' next
  instance, forward and backward, against the unpadded plain attention;
- every kernel gate accepting every entry of the matrix and refusing, with
  ROADMAP.md's queue named, what the kernels do not take;
- ``TRAINING_4D_ENCODER_QUANT``: the values JAX's trainer accepts and
  rejects.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.config import load_config as jax_load_config
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.models import vit3d as jvit
from neurovit_tpu.ops import flash_attention as jfa
from neurovit_tpu.ops import fused_mlp as jmlp
from neurovit_tpu.ops import fused_outproj as jout
from neurovit_tpu.ops import fused_qkv as jqkv
from neurovit_tpu_torch.config import load_config
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops import fused_mlp, fused_outproj, fused_qkv
from neurovit_tpu_torch.ops import int8_serving as q8
from neurovit_tpu_torch.ops.common import SMEM_LIMIT
from neurovit_tpu_torch.training.state_dict import from_jax_params
from neurovit_tpu_torch.training.trainer import check_supported

torch.set_num_threads(1)

NARROW = ["hd32", "hd80"]
TOL = {"f32": dict(rtol=1e-3, atol=1e-3), "bf16": dict(rtol=0, atol=5e-2)}
JDT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _overrides(width, precision="f32", impl="xla"):
    dim, heads, dim_head, mlp = WIDTHS[width]
    return {"TRAINING_VIT_INPUT_SIZE": 10, "TRAINING_VIT_PATCH_SIZE": 5,
            "DATASET_NAME": "adni", "TRAINING_PRECISION": precision,
            "TRAINING_DROPOUT": 0.0, "MODEL_VIT_DIM": dim,
            "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": heads,
            "MODEL_VIT_DIM_HEAD": dim_head, "MODEL_VIT_MLP_DIM": mlp,
            "KERNEL_IMPL": impl}


def _models(width, precision, impl, seed):
    jmodel = JaxNeuroEncoder(jax_load_config(
        overrides=_overrides(width, precision, impl)))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed))[
        "params"])
    model = NeuroEncoder(load_config(overrides=_overrides(width, precision)),
                         device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return jmodel, params, model


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("width", NARROW)
def test_logits_match_jax_at_width(width, impl, precision):
    jmodel, params, model = _models(width, precision, impl, len(width))
    vols = np.random.default_rng(4).standard_normal(
        (2, 10, 10, 10)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(vols))
    want, _ = jmodel.apply(params, jnp.asarray(vols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL[precision])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("width", ["smoke"] + NARROW)
def test_block_matches_jax_at_width(width, impl):
    """Block 0 (attention and MLP with their residuals) on 9 tokens, f32."""
    jmodel, params, model = _models(width, "f32", impl, 7)
    block = jvit.unstack_blocks(params["volume_encoder"]["blocks"], 2)[0]
    x = np.random.default_rng(5).standard_normal(
        (2, 9, WIDTHS[width][0])).astype(np.float32)
    want, _ = jvit._block_apply(jax.tree.map(jnp.asarray, block),
                                jnp.asarray(x), jmodel.vit_cfg,
                                deterministic=True, rng=None)
    attn, ff = model.volume_encoder.vit3d.transformer.layers[0]
    with torch.no_grad():
        got = ff(attn(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])


def _act(rng, shape, jdt):
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32)))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("width", NARROW)
def test_ops_match_jax_pallas_at_width(width, precision):
    """The four fused ops against the Pallas kernels in interpret mode, on
    13 tokens with 11 valid keys."""
    jdt, tdt = JDT[precision]
    dim, heads, dh, hid = WIDTHS[width]
    inner = heads * dh
    rng = np.random.default_rng(dim)
    xj, xt = _act(rng, (2, 13, dim), jdt)
    xt = xt.to(tdt)

    def lin(fan_in, fan_out):
        bound = fan_in ** -0.5
        return (rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
                rng.uniform(-bound, bound, fan_out).astype(np.float32))

    gamma = (1 + 0.2 * rng.standard_normal(dim)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    wqkv, _ = lin(dim, 3 * inner)
    wout, bout = lin(inner, dim)
    w1, b1 = lin(dim, hid)
    w2, b2 = lin(hid, dim)
    t = torch.from_numpy

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **TOL[precision])

    ln = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    want = jqkv.fused_ln_qkv({"attn_norm": ln,
                              "qkv": {"kernel": jnp.asarray(wqkv)}},
                             xj, heads, dh)
    got = fused_qkv.fused_ln_qkv(xt, t(gamma), t(beta), t(wqkv.T), heads, dh)
    for a, b in zip(got, want):
        close(a, b)
    qj, kj, vj = want
    want = jfa.flash_attention(qj, kj, vj, scale=dh ** -0.5, n_valid=11,
                               layout="bnhd")
    got = fa.flash_attention(*got, scale=dh ** -0.5, n_valid=11)
    close(got, want)
    aj, at = want.reshape(2, 13, inner), got.reshape(2, 13, inner)
    want = jout.fused_outproj_residual(
        {"kernel": jnp.asarray(wout), "bias": jnp.asarray(bout)}, xj, aj,
        deterministic=True)
    close(fused_outproj.fused_outproj_residual(xt, at, t(wout.T), t(bout)),
          want)
    want = jmlp.fused_mlp_block(
        {"mlp_norm": ln, "fc1": {"kernel": jnp.asarray(w1),
                                 "bias": jnp.asarray(b1)},
         "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}},
        xj, deterministic=True)
    close(fused_mlp.fused_mlp_block(xt, t(gamma), t(beta), t(w1.T), t(b1),
                                    t(w2.T), t(b2)), want)


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("d", [8, 12, 24, 40, 80, 100])
def test_head_dim_padding_is_exact(d, layout):
    """The kernels' head-dim padding (zero columns to the next instance,
    the result sliced back) leaves the forward and the backward of the real
    columns as they are: the plain attention run padded equals it run
    unpadded, up to f32 sums over D taken in another order. The inputs are
    small integers, so the products over D and their sums are exact and
    the outputs agree to the last bit of f32 but for the p . v and
    backward sums over keys."""
    d_kernel = fa.kernel_head_dim(d)
    assert d_kernel in fa.HEAD_DIMS and d <= d_kernel <= 2 * d
    rng = np.random.default_rng(d)
    shape = (2, 21, 3, d) if layout == "bnhd" else (2, 3, 21, d)
    q, k, v, do = (torch.from_numpy(rng.integers(-2, 3, shape).astype(
        np.float32) * 0.25) for _ in range(4))
    kw = dict(scale=d ** -0.5, n_valid=17, dropout_rate=0.1, seed=5,
              layout=layout)
    o, lsum = fa._fwd_plain(q, k, v, **kw)
    o_p, lsum_p = fa._fwd_plain(*(fa.pad_head_dim(x, d_kernel)
                                  for x in (q, k, v)), **kw)
    assert torch.all(o_p[..., d:] == 0)
    torch.testing.assert_close(o_p[..., :d], o, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(lsum_p, lsum, rtol=0, atol=0)
    grads = fa._bwd_plain(q, k, v, o, do, lsum, **kw)
    grads_p = fa._bwd_plain(*(fa.pad_head_dim(x, d_kernel)
                              for x in (q, k, v, o, do)), lsum, **kw)
    for g, g_p in zip(grads, grads_p):
        assert torch.all(g_p[..., d:] == 0)
        torch.testing.assert_close(g_p[..., :d], g, rtol=1e-6, atol=1e-7)


def test_head_dim_instances():
    assert [fa.kernel_head_dim(d) for d in (8, 16, 17, 32, 33, 64, 65, 80,
                                            128)] == \
        [16, 16, 32, 32, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="head dim <= 128.*Queue 3"):
        fa.kernel_head_dim(160)
    with pytest.raises(ValueError, match="plain"):
        fa.kernel_head_dim(4)


def test_head_dim_below_8_runs_the_plain_attention():
    """Head dims below 8 take the plain attention on every device, where
    JAX's flash_attention takes its dense path (flash_attention.py:517-520),
    here forward and backward with dropout. (The 4D temporal layer, head dim
    1, has an attention of its own: models/temporal.py.)"""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 2, 1)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    q_j, k_j, v_j = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))
    want = jfa.flash_attention(q_j, k_j, v_j, scale=1.0, layout="bnhd")
    got = fa.flash_attention(q, k, v, scale=1.0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    fa.flash_attention(q, k, v, scale=1.0, dropout_rate=0.1,
                       seed=3).sum().backward()
    assert torch.isfinite(q.grad).all()


@pytest.mark.parametrize("width", list(WIDTHS))
def test_kernel_gates_accept_every_width(width):
    dim, heads, dh, hid = WIDTHS[width]
    inner = heads * dh
    fused_qkv.check_fwd_shapes(dim, inner)
    fused_qkv.check_bwd_shapes(dim, inner)
    fused_outproj.check_fwd_shapes(dim, inner)
    fused_outproj.check_bwd_shapes(dim, inner)
    # K4: three launches at any multiple-of-16 width, each GEMM block
    # within a block's shared memory, the scratch holding u and g.
    plan = fused_mlp.mlp_plan(1001, dim, hid)
    assert [name for name, *_ in plan.launches] == ["ln_rows", "fc1_gelu",
                                                     "fc2_residual"]
    assert all(smem <= SMEM_LIMIT for *_, smem in plan.launches)
    assert plan.scratch_bytes >= 1001 * (dim + hid) * 2
    # K9: five launches, its GEMM passes on K4's tiles, the scratch holding
    # du in f32.
    fused_mlp.check_bwd_shapes(dim, hid)
    bwd = fused_mlp.mlp_bwd_plan(1001, dim, hid)
    assert [name for name, *_ in bwd.launches] == [
        "dz_rows", "hidden", "du", "ln_bwd", "colsum"]
    assert all(smem <= SMEM_LIMIT for *_, smem in bwd.launches)
    assert bwd.scratch_bytes >= 1001 * dim * 4
    q8.check_qkv_shapes(dim, inner)
    q8.check_outproj_shapes(dim, inner)
    q8.check_mlp_shapes(dim, hid)
    assert fa.kernel_head_dim(dh) >= dh


@pytest.mark.parametrize("gate,args,match", [
    (fused_qkv.check_fwd_shapes, (72, 64), "dim as a multiple of 16"),
    (fused_qkv.check_fwd_shapes, (64, 40), "inner as a multiple of 16"),
    (fused_qkv.check_bwd_shapes, (1288, 512), "dim as a multiple of 16"),
    (fused_outproj.check_fwd_shapes, (1000, 512), "multiple of 16"),
    (fused_mlp.check_fwd_shapes, (1024, 2056), "multiple of 16"),
    (fused_mlp.check_bwd_shapes, (1536, 6152), "mlp_dim as a multiple of 16"),
    (q8.check_qkv_shapes, (1288, 1280), "dim as a multiple of 16"),
    (q8.check_outproj_shapes, (1024, 1288), "inner as a multiple of 16"),
    (q8.check_mlp_shapes, (1024, 8200), "mlp_dim as a multiple of 16"),
    (fa.kernel_head_dim, (256,), "head dim <= 128"),
])
def test_kernel_gates_refuse_and_name_the_queue(gate, args, match):
    with pytest.raises(ValueError, match=match) as err:
        gate(*args)
    assert "ROADMAP.md, Queue 3" in str(err.value)


@pytest.mark.parametrize("dim,hid", [(1024, 8192), (1280, 5120),
                                     (1536, 6144)])
def test_mlp_gate_accepts_the_widths_once_refused(dim, hid):
    """K4 kept u and g of 16 or 32 rows in shared memory and refused mlp
    8192 at dim 1024 (and ViT-H's 1280 / 5120); K9 held a LayerNorm row in
    one warp's registers and refused dim > 1024 (ViT-H, 1536 / 6144). On
    TMA + wgmma both take them, and so do their plans."""
    fused_mlp.check_fwd_shapes(dim, hid)
    fused_mlp.check_bwd_shapes(dim, hid)
    for plan in (fused_mlp.mlp_plan(8008, dim, hid),
                 fused_mlp.mlp_bwd_plan(8008, dim, hid)):
        assert plan.launches[1][1] == (hid // 128, 63)
        assert plan.launches[2][1] == (dim // 128, 63)


@pytest.mark.parametrize("dim,inner", [(1280, 1280), (1024, 1536),
                                       (2048, 2048)])
def test_int8_outproj_gate_accepts_the_widths_once_refused(dim, inner):
    """K11 held a row of a in one warp's registers and refused inner past
    1024 (ViT-H's 1280 among them). On its row quantizer and K12's
    fc2_residual pass it takes them, and so does its plan: two launches,
    the GEMM over dim / 128 column tiles, a8 [m, inner] first in the
    scratch."""
    q8.check_outproj_shapes(dim, inner)
    plan = q8.int8_outproj_plan(8008, dim, inner)
    assert [name for name, *_ in plan.launches] == ["rowquant",
                                                     "fc2_residual"]
    assert plan.launches[1][1] == (dim // 128, 63)
    assert plan.scratch["a8"] == (0, 8008 * inner)


@pytest.mark.parametrize("dim,inner", [(1024, 2048), (2048, 2048)])
def test_outproj_gate_accepts_the_widths_once_refused(dim, inner):
    """K3 kept a 64-row block of a in shared memory beside its wmma tiles
    and refused inner past 1536 ("bytes of shared memory"). As K4's
    fc2_residual pass it takes them, and so does its plan: one launch over
    dim / 128 column tiles. K8 refused dim 2048 for its dz block; on K9's
    dz rows pass and a TMA + wgmma GEMM it takes dim 2048 too, and plans
    it: dz rows, then dattn over inner / 128 column tiles."""
    fused_outproj.check_fwd_shapes(dim, inner)
    plan = fused_outproj.outproj_plan(8008, dim, inner)
    assert [name for name, *_ in plan.launches] == ["fc2_residual"]
    assert plan.launches[0][1] == (dim // 128, 63)
    fused_outproj.check_bwd_shapes(2048, inner)
    bplan = fused_outproj.outproj_bwd_plan(8008, 2048, inner, 0.1)
    assert [name for name, *_ in bplan.launches] == ["dz_rows", "dattn"]
    assert bplan.launches[1][1] == (inner // 128, 63)


@pytest.mark.parametrize("dim,inner", [(2048, 512), (2048, 2048)])
def test_qkv_gate_accepts_the_widths_once_refused(dim, inner):
    """K2 kept a [64, dim] u block in shared memory beside its GEMM tiles
    and refused dim past 1536 ("bytes of shared memory"). On K4's LayerNorm
    rows and the TMA + wgmma GEMM it takes them, and so does its plan: two
    launches, the GEMM over 3 inner / 128 column tiles."""
    fused_qkv.check_fwd_shapes(dim, inner)
    plan = fused_qkv.qkv_plan(8008, dim, inner)
    assert [name for name, *_ in plan.launches] == ["ln_rows", "qkv_gemm"]
    assert plan.launches[1][1] == (3 * inner // 128, 63)
    assert plan.scratch["u"] == (0, 8008 * dim * 2)


@pytest.mark.parametrize("dim,inner", [(1280, 1280), (1536, 1536)])
def test_qkv_bwd_gate_accepts_the_widths_once_refused(dim, inner):
    """K7 held a LayerNorm row in one warp's registers and refused dim >
    1024 (ViT-H, 1280 / 1280; 1536 / 1536). On K9's TMA + wgmma passes it
    takes them, and so does its plan: four launches, the du GEMM over 128
    columns of dim."""
    fused_qkv.check_bwd_shapes(dim, inner)
    plan = fused_qkv.qkv_bwd_plan(8008, dim, inner)
    assert [name for name, *_ in plan.launches] == [
        "row_stats", "du", "ln_bwd", "colsum"]
    assert plan.launches[1][1] == (dim // 128, 63)
    assert plan.scratch["du"] == (0, 8008 * dim * 4)


@pytest.mark.parametrize("dim,inner", [(1280, 1280), (1536, 1536)])
def test_int8_qkv_gate_accepts_the_widths_once_refused(dim, inner):
    """K10 held a LayerNorm row in one warp's registers and refused dim >
    1024 (ViT-H, 1280 / 1280; 1536 / 1536). Its LN row quantizer is a pass
    of its own on TMA + wgmma, so it takes them, and so does its plan."""
    q8.check_qkv_shapes(dim, inner)
    plan = q8.qkv_plan(8008, dim, inner)
    assert plan.launches[1][1] == (3 * inner // 128, 63)
    assert plan.scratch["u8"] == (0, 8008 * dim)


@pytest.mark.parametrize("value", [None, "", "none", "int8"])
def test_encoder_quant_values_jax_accepts(value):
    config = load_config(overrides=_overrides("smoke"))
    if value is not None:
        config["TRAINING_4D_ENCODER_QUANT"] = value
    else:
        config.pop("TRAINING_4D_ENCODER_QUANT", None)
    check_supported(config, torch.device("cpu"))


@pytest.mark.parametrize("value", ["fp8", "INT8", "int4", 8])
def test_encoder_quant_values_jax_rejects(value):
    """The message is JAX's (neurovit_tpu/training/trainer.py:110-112)."""
    config = dict(load_config(overrides=_overrides("smoke")),
                  TRAINING_4D_ENCODER_QUANT=value)
    with pytest.raises(ValueError, match=(
            rf"unknown TRAINING_4D_ENCODER_QUANT {value!r} \(supported: "
            r"'int8'\)")):
        check_supported(config, torch.device("cpu"))
