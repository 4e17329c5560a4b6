"""The port's Grad-CAM slice (plain PyTorch on the CPU) against the JAX
package on the same weights and inputs, at a tiny 3D ViT: grid 20, patch
5, dim 64, depth 2, 4 heads of 16, MLP 128, 8 classes (the synthetic cube
task); and K6, the bhnd flash attention, against JAX's Pallas kernel in
interpret mode.

Tolerances: f32 within 1e-5 abs + 1e-4 rel (sums in another order); bf16
within 5e-2 of max|ref| (the same rounding points, an ulp now and then);
raw patch-grid CAMs within 1e-4 of their largest magnitude and final maps
(in [0, 1]) within 1e-4, both at f32; the CAM tail's pieces within 1e-5.

The models here take random weights with the LayerNorm affines moved off
their init (ones, zeros): with gamma 1 and beta 0 the probe activation
sums to zero over the features, so gradcam-ref's raw map (mean gradient
times that sum) is zero up to rounding and its normalized map is noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.config import load_config
from neurovit_tpu.explainability import cam_methods as jcam
from neurovit_tpu.explainability import gradcam_vit3d as jgc
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.ops import flash_attention as jfa
from neurovit_tpu_torch.explainability import cam_methods as cam
from neurovit_tpu_torch.explainability import gradcam_vit3d as gc
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.models.vit3d import PROBE_INT8, quantize_blocks
from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops.attention import _sdpa_xla, sdpa
from neurovit_tpu_torch.training.state_dict import from_jax_params

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
GRID = 20


def gradcam_config(precision="f32", impl="xla", **extra):
    return load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": GRID, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "gradcam", "GRADCAM_CUBE_SIZE": 8,
        "TRAINING_PRECISION": precision, "TRAINING_DROPOUT": 0.0,
        "MODEL_VIT_DIM": 64, "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4,
        "MODEL_VIT_DIM_HEAD": 16, "MODEL_VIT_MLP_DIM": 128,
        "KERNEL_IMPL": impl, **extra})


def model_pair(precision="f32", impl="xla", seed=3, **extra):
    """(JAX model, its params, the port's model on the same weights)."""
    config = gradcam_config(precision, impl, **extra)
    jmodel = JaxNeuroEncoder(config)
    params = jax.tree.map(np.asarray,
                          jmodel.init(jax.random.key(seed))["params"])
    rng = np.random.default_rng(seed)

    def lift(path, a):
        names = [p.key for p in path]
        if "norm" not in names[-2]:
            return a
        noise = 0.3 * rng.standard_normal(a.shape).astype(np.float32)
        return (1.0 + noise) if names[-1] == "scale" else noise

    params = jax.tree_util.tree_map_with_path(lift, params)
    model = NeuroEncoder(config, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return jmodel, params, model


@pytest.fixture(scope="module")
def f32_pair():
    return model_pair()


def volumes(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, GRID, GRID, GRID)).astype(np.float32)


def close(got, want, dtype="f32"):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-2 * float(np.abs(want).max()))


def close_scaled(got, want, rel=1e-4):
    """Within ``rel`` of the reference's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# --- K6: the bhnd flash attention ------------------------------------------

def _pair(a, jdt, tdt, grad=True):
    j = jnp.asarray(np.asarray(a, np.float32)).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t.requires_grad_(grad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,n_valid", [(65, 60), (100, 91)])
def test_k6_forward_and_backward_match_jax(dtype, n, n_valid):
    """flash_attention(layout="bhnd") and its backward against JAX's
    ``_flash(..., "bhnd")`` (the Pallas ``_fwd_kernel`` / ``_bwd_kernel``
    in interpret mode) and ``jax.vjp`` of it."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(n)
    shape = (2, 4, n, 16)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.standard_normal(shape), jdt,
                                          tdt) for _ in range(3))
    gj, gt = _pair(rng.standard_normal(shape), jdt, tdt, grad=False)
    seed = jnp.zeros((1, 1), jnp.int32)
    out, pull = jax.vjp(lambda q, k, v: jfa._flash(q, k, v, 0.25, 0.0, n_valid,
                                                   seed, "bhnd"), qj, kj, vj)
    o = fa.flash_attention(qt, kt, vt, scale=0.25, n_valid=n_valid,
                           layout="bhnd")
    o.backward(gt)
    close(o, out, dtype)
    for got, want in zip((qt.grad, kt.grad, vt.grad), pull(gj)):
        close(got, want, dtype)
    assert not kt.grad[:, :, n_valid:].any()
    assert not vt.grad[:, :, n_valid:].any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k6_plain_equals_bnhd_plain_on_transposed_inputs(rate):
    """One function in two layouts: the same bits forward and backward,
    dropout mask included (it is indexed by (b, h, q, k))."""
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(torch.bfloat16)

    q, k, v, do = (t(2, 3, 70, 64) for _ in range(4))
    kw = dict(scale=0.125, n_valid=61, dropout_rate=rate, seed=99)

    def tr(x):
        return x.transpose(1, 2).contiguous()

    o, lsum = fa.flash_attention_bhnd_plain(q, k, v, return_stats=True, **kw)
    o2, lsum2 = fa.flash_attention_plain(tr(q), tr(k), tr(v),
                                         return_stats=True, **kw)
    assert torch.equal(o, tr(o2)) and torch.equal(lsum, lsum2)
    grads = fa.flash_attention_bhnd_bwd_plain(q, k, v, o, do, lsum, **kw)
    grads2 = fa.flash_attention_bwd_plain(tr(q), tr(k), tr(v), o2, tr(do),
                                          lsum2, **kw)
    for g, g2 in zip(grads, grads2):
        assert torch.equal(g, tr(g2))


def test_sdpa_matches_the_dense_softmax():
    """K6's exp2 softmax clamped at +-96 is the row-max softmax for scores
    inside the clamp (f32)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 33, 16))
                                .astype(np.float32)) for _ in range(3))
    np.testing.assert_allclose(sdpa(q, k, v, scale=0.25).numpy(),
                               _sdpa_xla(q, k, v, scale=0.25).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_layout_is_checked():
    q = torch.zeros(1, 2, 5, 8)
    with pytest.raises(ValueError, match="layout"):
        fa.flash_attention(q, q, q, scale=1.0, layout="bnd")


# --- the probe ------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_probe_matches_jax(precision, impl):
    """Logits, probe activations and their gradients against JAX's
    ``probe_acts_grads`` (``pallas``: the Pallas kernels in interpret mode on
    the lane-padded stream, K6 in the last block)."""
    jmodel, params, model = model_pair(precision, impl)
    x = volumes(11)
    logits, idx, acts, grads = jgc.probe_acts_grads(jmodel, params,
                                                    jnp.asarray(x))
    t_logits, t_idx, t_acts, t_grads = gc.probe_acts_grads(
        model, torch.from_numpy(x))
    close(t_logits, logits, precision)
    assert t_idx.tolist() == np.asarray(idx).tolist()
    close(t_acts, acts, precision)
    close(t_grads, grads, precision)
    assert float(t_grads.abs().sum()) > 0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_probe_with_zero_shift_gives_the_forward_logits(precision):
    _, _, model = model_pair(precision)
    x = torch.from_numpy(volumes(12))
    cfg = model.vit_cfg
    with torch.no_grad():
        want = model(x)
        got, acts = model.probe(x, torch.zeros(2, cfg.num_patches + 1,
                                               cfg.dim))
    assert acts.dtype == model.compute_dtype
    close(got, want.numpy(), precision)


def test_probe_refuses_int8_blocks():
    _, _, model = model_pair()
    quantize_blocks(model.volume_encoder.vit3d)
    with pytest.raises(ValueError, match="bf16 weights"):
        model.get_attention_map(volumes(13, 1)[0])
    assert "int8-quantized" in PROBE_INT8


def test_probe_prefix_records_no_graph(monkeypatch):
    """Blocks 0..depth-2 run without a graph: the attention K6 of the last
    block is the only attention whose forward keeps row sums for a
    backward."""
    _, _, model = model_pair()
    calls = []
    real = fa.FlashAttention.forward

    def spy(ctx, q, k, v, *args):
        calls.append(args[-1])
        return real(ctx, q, k, v, *args)

    monkeypatch.setattr(fa.FlashAttention, "forward", staticmethod(spy))
    gc.probe_acts_grads(model, torch.from_numpy(volumes(14, 1)))
    assert calls == ["bhnd"]


# --- the CAM tail ---------------------------------------------------------

@pytest.mark.parametrize("threshold", [5.0, 20.0, 50.0])
def test_finalize_cam_matches_jax(threshold):
    raw = np.random.default_rng(int(threshold)).standard_normal(
        (3, 4, 4, 4)).astype(np.float32)
    want = jgc.finalize_cam(jnp.asarray(raw), GRID, threshold)
    got = gc.finalize_cam(torch.from_numpy(raw), GRID, threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(
        gc.token_grid_to_volume(torch.from_numpy(raw)).numpy(),
        np.asarray(jgc.token_grid_to_volume(jnp.asarray(raw))))


@pytest.mark.parametrize("shape,out,method", [
    ((2, 10, 10, 10), (90, 90, 90), "trilinear"),
    ((2, 4, 4, 4), (20, 20, 20), "trilinear"),
    ((3, 14, 14), (224, 224), "bilinear")])
def test_upsample_and_percentile_match_jax(shape, out, method):
    """F.interpolate(align_corners=False) equals jax.image.resize on an
    upsample, edges included; torch.quantile(linear) equals
    jnp.percentile, per sample."""
    a = np.random.default_rng(len(out)).random(shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(a), (shape[0],) + out, method=method)
    got = torch.nn.functional.interpolate(
        torch.from_numpy(a)[:, None], size=out, mode=method,
        align_corners=False)[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    flat = a.reshape(shape[0], -1)
    for pct in (95.0, 80.0, 50.0):
        np.testing.assert_allclose(
            torch.quantile(torch.from_numpy(flat), pct / 100.0, dim=1,
                           interpolation="linear").numpy(),
            np.asarray(jnp.percentile(jnp.asarray(flat), pct, axis=1)),
            atol=1e-5)


def test_reshape_transform_and_visualize_slice(tiny_config):
    tokens = np.random.default_rng(1).standard_normal(
        (2, 1 + 4 * 3 * 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        gc.reshape_transform(tokens, 4, 3, 5).numpy(),
        np.asarray(jgc.reshape_transform(tokens, 4, 3, 5)))
    cam_, vol = (np.random.default_rng(s).random((20, 20, 20))
                 for s in (2, 3))
    for dim in (0, 1, 2):
        config = dict(tiny_config, GRADCAM_SLICE_DIM=dim, GRADCAM_SLICE_IDX=5)
        for got, want in zip(gc.visualize_slice(config, cam_, vol),
                             jgc.visualize_slice(config, cam_, vol)):
            np.testing.assert_array_equal(got, want)
    assert gc.visualize_slice(dict(tiny_config, GRADCAM_SLICE_DIM=7), cam_,
                              vol) is None


# --- get_attention_map and the menu --------------------------------------

def test_get_attention_map_matches_jax(f32_pair):
    jmodel, params, model = f32_pair
    x = volumes(21)
    want, want_idx = jgc.get_attention_map(jmodel, {"params": params}, x)
    got, got_idx = model.get_attention_map(x)
    assert got.shape == (2, GRID, GRID, GRID)
    assert got_idx.tolist() == want_idx.tolist()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # One volume: squeezed, equal to its row of the batch.
    one, idx = model.get_attention_map(x[1])
    assert one.shape == (GRID,) * 3 and idx.tolist() == [got_idx[1]]
    np.testing.assert_allclose(one, got[1], atol=1e-5)


def _orient(raw):
    """The port's orientation of a principal projection: each sample's
    entry of largest magnitude positive (cam_methods._principal_projection;
    JAX's own orientation is rounding noise)."""
    raw = np.asarray(raw, np.float32)
    flat = raw.reshape(raw.shape[0], -1)
    peak = flat[np.arange(len(flat)), np.abs(flat).argmax(axis=1)]
    return raw * np.where(peak < 0, -1.0, 1.0).reshape(
        (-1,) + (1,) * (raw.ndim - 1)).astype(np.float32)


def _eigen(method, eigen_smooth):
    return eigen_smooth or method in ("eigencam", "eigengradcam")


def _raw_cams(jmodel, params, model, x, method, eigen_smooth):
    if method in cam.GRAD_METHODS:
        want = jcam._grad_cam_raw_jit(jmodel, params, jnp.asarray(x), method,
                                      eigen_smooth)
        got = cam._grad_cam_raw(model, torch.from_numpy(x), method,
                                eigen_smooth)
    else:
        want = jcam._forward_cam_raw(jmodel, params, jnp.asarray(x), method,
                                     32, eigen_smooth)
        with torch.inference_mode():
            got = cam._forward_cam_raw(model, torch.from_numpy(x), method,
                                       32, eigen_smooth)
    return got, want


@pytest.mark.parametrize("eigen_smooth", [False, True])
@pytest.mark.parametrize("method", cam.GRAD_METHODS + cam.FORWARD_METHODS)
def test_raw_cam_matches_jax(f32_pair, method, eigen_smooth):
    jmodel, params, model = f32_pair
    (got, got_idx), (want, want_idx) = _raw_cams(
        jmodel, params, model, volumes(22, 1), method, eigen_smooth)
    assert got_idx.tolist() == np.asarray(want_idx).tolist()
    if _eigen(method, eigen_smooth):
        want = _orient(want)
    close_scaled(got.numpy(), want)


def _jax_cam(jmodel, params, model, x, method, threshold=None, **kw):
    """JAX's compute_cam; for a principal projection, JAX's raw map in the
    port's orientation through JAX's tail."""
    eigen_smooth = kw.get("eigen_smooth", False)
    if method == "gradcam-ref" or not _eigen(method, eigen_smooth):
        return jcam.compute_cam(jmodel, {"params": params}, x, method=method,
                                threshold=threshold, **kw)
    (_, _), (raw, idx) = _raw_cams(jmodel, params, model, x[None], method,
                                   eigen_smooth)
    threshold = threshold or float(jmodel.config["GRADCAM_THRESHOLD"])
    return np.asarray(jgc.finalize_cam(jnp.asarray(_orient(raw)), GRID,
                                       threshold))[0], np.asarray(idx)


@pytest.mark.parametrize("method", cam.METHODS)
def test_compute_cam_matches_jax(f32_pair, method):
    jmodel, params, model = f32_pair
    x = volumes(23, 1)[0]
    want, want_idx = _jax_cam(jmodel, params, model, x, method)
    got, got_idx = cam.compute_cam(model, x, method=method)
    assert got.shape == (GRID,) * 3
    assert got_idx.tolist() == np.asarray(want_idx).tolist()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert 0.0 <= got.min() and got.max() <= 1.0 + 1e-6


@pytest.mark.parametrize("method,kw", [
    ("gradcam", {"aug_smooth": True}),
    ("layercam", {"aug_smooth": True, "threshold": 20.0}),
    ("gradcam", {"eigen_smooth": True}),
    ("ablationcam", {"eigen_smooth": True}),
    ("gradcam", {"threshold": 30.0})])
def test_compute_cam_flags_match_jax(f32_pair, method, kw):
    jmodel, params, model = f32_pair
    x = volumes(24, 1)[0]
    want, _ = _jax_cam(jmodel, params, model, x, method, **kw)
    got, _ = cam.compute_cam(model, x, method=method, **kw)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_compute_cam_refuses_what_jax_refuses(f32_pair):
    _, _, model = f32_pair
    x = volumes(25, 1)[0]
    with pytest.raises(ValueError, match="method must be one of"):
        cam.compute_cam(model, x, method="fullgrad")
    with pytest.raises(ValueError, match="no smoothing flags"):
        cam.compute_cam(model, x, method="gradcam-ref", aug_smooth=True)


def test_batched_cam_equals_single_calls(f32_pair):
    _, _, model = f32_pair
    x = volumes(26, 3)
    batched, idx = cam.compute_cam(model, x, method="layercam")
    for i in range(3):
        one, one_idx = cam.compute_cam(model, x[i], method="layercam")
        assert one_idx.tolist() == [idx[i]]
        np.testing.assert_allclose(batched[i], one, atol=1e-5)


def test_principal_projection_and_masks_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 27, 16)).astype(np.float32)
    got = cam._principal_projection(torch.from_numpy(a)).numpy()
    close_scaled(got, _orient(jcam._principal_projection(jnp.asarray(a))))
    # The orientation is a property of the input, not of the SVD's sign.
    np.testing.assert_allclose(
        cam._principal_projection(torch.from_numpy(-a)).numpy(), got,
        atol=1e-5)
    acts = rng.standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        cam._channel_masks_hwd(torch.from_numpy(acts), 4, GRID).numpy(),
        np.asarray(jcam._channel_masks_hwd(jnp.asarray(acts), 4, GRID)),
        atol=1e-5)


def test_jax_eigen_orientation_is_rounding_noise():
    """Why the port orients the projections itself: JAX's orientation
    statistic sum(relu(p) - relu(-p)) is sum(p), and the projection of
    spatially-centered rows sums to zero, so its sign is rounding noise."""
    a = np.random.default_rng(1).standard_normal((4, 64, 32)).astype(
        np.float32)
    proj = np.asarray(jcam._principal_projection(jnp.asarray(a)))
    assert np.all(np.abs(proj.sum(axis=1)) < 1e-5 * np.abs(proj).sum(axis=1))


# --- the trained model localizes the cube --------------------------------

def test_cam_localizes_cube_after_training(tiny_config):
    """tests/test_gradcam_localization.py's protocol on the port: a tiny
    model trained on the cube task by the port's Trainer puts more
    gradcam-ref mass inside the cube than outside on most val samples."""
    from neurovit_tpu.data import get_datasets
    from neurovit_tpu_torch.training import Trainer

    config = dict(tiny_config, TRAINING_EPOCHS=4, TRAINING_LEARNING_RATE=1e-3,
                  GRADCAM_NUM_SAMPLES=160, DATASET_GENERATE=True,
                  GRADCAM_THRESHOLD=20)
    ds_train, ds_val = get_datasets(config)
    model = NeuroEncoder(config, device="cpu")
    trainer = Trainer(config, model, ds_train, ds_val)
    trainer.run()
    acc = trainer.evaluate_samples()
    assert acc > 0.8, f"model did not learn ({acc}); CAM check meaningless"
    hits = 0
    for idx in range(6):
        sample = ds_val.sample(idx)
        cam_, _ = model.get_attention_map(sample["volume"])
        cube = sample["volume"] == 1.0
        hits += int(cam_[cube].mean() > cam_[~cube].mean())
    assert hits >= 4, f"CAM localization weak: {hits}/6"
