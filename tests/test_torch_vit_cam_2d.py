"""The port's 2D ViT CAM tutorial (``vit_cam_2d``, plain PyTorch on the
CPU) against the JAX package's: the JAX ``ViT2D`` drawn as JAX's
``train_demo_model`` draws it (the first key of ``jax.random.key(0)``'s
split), its params carried across by ``ViT2D.load_jax``, and the same
numpy images into both.

Tolerances: logits, probe activations and gradients within 1e-5 abs +
1e-4 rel (JAX's ``impl="xla"`` takes the row-max softmax, the port the
exp2 softmax clamped at +-96; at these scores the two agree to rounding);
CAMs (in [0, 1]) within 1e-4; one AdamW step's loss and parameters within
1e-5 abs + 1e-4 rel. The eigen methods and ``eigen_smooth`` are compared
as in tests/test_torch_gradcam.py: JAX's raw maps in the port's
orientation through JAX's tail.
"""

import jax
import jax.numpy as jnp
import matplotlib.image as mpimg
import numpy as np
import optax
import pytest
import torch

from neurovit_tpu.explainability import vit_cam_2d as jv
from neurovit_tpu.explainability.gradcam_vit3d import \
    probe_acts_grads as jprobe_acts_grads
from neurovit_tpu_torch.explainability import vit_cam_2d as v2
from neurovit_tpu_torch.explainability.gradcam_vit3d import probe_acts_grads
from neurovit_tpu_torch.training.state_dict import PREFIX, from_jax_params
from test_torch_gradcam import _eigen, _orient

torch.set_num_threads(1)

SIZE = v2.IMAGE_SIZE
FLAGS = {"plain": {}, "aug_smooth": {"aug_smooth": True},
         "eigen_smooth": {"eigen_smooth": True}}


@pytest.fixture(scope="module")
def pair():
    """(JAX ViT2D, its params as numpy, the port's ViT2D on them)."""
    jmodel = jv.ViT2D()
    k_init, _ = jax.random.split(jax.random.key(0))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(k_init)["params"])
    return jmodel, params, v2.ViT2D(device="cpu").load_jax(params)


def images(seed, n):
    return np.random.default_rng(seed).uniform(
        size=(n, SIZE, SIZE)).astype(np.float32)


def close(got, want, rtol=1e-4, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def test_constants_and_config_match_jax(pair):
    jmodel, _, model = pair
    assert (v2.IMAGE_SIZE, v2.PATCH_SIZE, v2.SQUARE_SIZE, v2.NUM_CLASSES) == (
        jv.IMAGE_SIZE, jv.PATCH_SIZE, jv.SQUARE_SIZE, jv.NUM_CLASSES)
    j, p = jmodel.vit_cfg, model.vit_cfg
    for field in ("image_size", "image_patch_size", "frames",
                  "frame_patch_size", "num_classes", "dim", "depth", "heads",
                  "dim_head", "mlp_dim", "channels", "pool", "num_patches"):
        assert getattr(p, field) == getattr(j, field), field
    assert model.config == jmodel.config
    assert model.device == torch.device("cpu")


def test_logits_and_probe_match_jax(pair):
    """The forward, and the probe's activations and gradients."""
    jmodel, params, model = pair
    x = images(1, 3)
    want, _ = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    close(model(torch.from_numpy(x)), want)
    jl, jidx, jacts, jgrads = jax.jit(jprobe_acts_grads, static_argnums=0)(
        jmodel, params, jnp.asarray(x))
    logits, idx, acts, grads = probe_acts_grads(model, torch.from_numpy(x))
    assert idx.tolist() == np.asarray(jidx).tolist()
    close(logits, jl)
    close(acts, jacts)
    close(grads, jgrads)


def _jax_raw(jmodel, params, x, method, eigen_smooth):
    if method in jv.cam_methods.GRAD_METHODS:
        return jv._grad_cam_raw_2d(jmodel, params, x, method, eigen_smooth)
    return jv._forward_cam_raw_2d(jmodel, params, x, method, 32, eigen_smooth)


def _jax_cam(jmodel, params, x, method, threshold, aug_smooth=False,
             eigen_smooth=False):
    """JAX's compute_cam_2d; for a principal projection, JAX's raw maps
    (each augmentation's) in the port's orientation through JAX's tail."""
    if not _eigen(method, eigen_smooth):
        return jv.compute_cam_2d(jmodel, {"params": params}, x, method=method,
                                 threshold=threshold, aug_smooth=aug_smooth,
                                 eigen_smooth=eigen_smooth)
    xb = jnp.asarray(x)[None]
    cam, idx = _jax_raw(jmodel, params, xb, method, eigen_smooth)
    cams = [_orient(cam)]
    if aug_smooth:
        for flip in (False, True):
            for scale in (0.9, 1.0, 1.1):
                if not flip and scale == 1.0:
                    continue
                xi = xb * scale
                if flip:
                    xi = xi[:, :, ::-1]
                cam_i = _orient(_jax_raw(jmodel, params, xi, method,
                                         eigen_smooth)[0])
                cams.append(cam_i[:, :, ::-1] if flip else cam_i)
    cam = np.mean(np.stack(cams), axis=0)
    return np.asarray(jv.finalize_cam_2d(jnp.asarray(cam), SIZE,
                                         threshold))[0], np.asarray(idx)


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("method", v2.METHODS_2D)
def test_compute_cam_2d_matches_jax(pair, method, flags):
    jmodel, params, model = pair
    x = images(2, 1)[0]
    want, want_idx = _jax_cam(jmodel, params, x, method, 20.0, **FLAGS[flags])
    got, got_idx = v2.compute_cam_2d(model, x, method=method, threshold=20.0,
                                     **FLAGS[flags])
    assert got.shape == (SIZE, SIZE)
    assert got_idx.tolist() == np.asarray(want_idx).tolist()
    assert 0.0 <= got.min() and got.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_gradcam_ref_refused(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="method must be one of"):
        v2.compute_cam_2d(model, images(3, 1)[0], method="gradcam-ref")


def test_batched_matches_per_sample(pair):
    _, _, model = pair
    x = images(4, 2)
    cam_b, idx_b = v2.compute_cam_2d(model, x, method="gradcam",
                                     threshold=20.0)
    assert cam_b.shape == (2, SIZE, SIZE)
    for i in range(2):
        cam_1, idx_1 = v2.compute_cam_2d(model, x[i], method="gradcam",
                                         threshold=20.0)
        assert idx_1.tolist() == [idx_b[i]]
        np.testing.assert_allclose(cam_b[i], cam_1, rtol=1e-4, atol=1e-5)


def test_train_step_matches_optax(pair):
    """One train_demo_model step against one step of optax.adamw(3e-4,
    weight_decay=0.01), JAX's demo optimizer: the same params (the
    fixture's), JAX's own squares, the same numpy batch indices."""
    jmodel, params0, _ = pair
    seed = 0
    _, k_data = jax.random.split(jax.random.key(seed))
    data = jv.make_squares(k_data, 2048)
    tx = optax.adamw(3e-4, weight_decay=0.01)

    @jax.jit
    def step(p, x, y):
        def loss_fn(p):
            logits, _ = jmodel.apply(p, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return optax.apply_updates(p, updates), loss

    idx = np.random.default_rng(seed).integers(0, len(data[0]), 32)
    want, want_loss = step(params0, jnp.asarray(data[0][idx]),
                           jnp.asarray(data[1][idx]))

    model = v2.ViT2D(device="cpu").load_jax(params0)
    losses = v2.train_demo_model(model, steps=1, seed=seed, verbose=False,
                                 data=data)
    assert losses.shape == (1,)
    close(losses[0], want_loss)
    want_state = from_jax_params({"volume_encoder": jax.tree.map(np.asarray,
                                                                 want)})
    got_state = model.vit3d.state_dict()
    assert len(got_state) == len(want_state)
    for key, value in want_state.items():
        got = got_state[key[len(PREFIX):]]
        close(got, value.numpy())


def test_make_squares_labels_match_positions():
    imgs, labels = v2.make_squares(16, generator=torch.Generator()
                                   .manual_seed(7))
    cells = SIZE // v2.SQUARE_SIZE
    assert imgs.shape == (16, SIZE, SIZE) and imgs.dtype == np.float32
    assert labels.dtype == np.int64
    assert set(np.unique(labels)).issubset(range(cells * cells))
    for img, label in zip(imgs, labels):
        y = label // cells * v2.SQUARE_SIZE
        x = label % cells * v2.SQUARE_SIZE
        assert (img[y:y + v2.SQUARE_SIZE, x:x + v2.SQUARE_SIZE] == 1.0).all()
        # One square of ones; the background stays below the noise level.
        assert (img == 1.0).sum() == v2.SQUARE_SIZE ** 2
        assert img[img != 1.0].max() < 0.1
    again = v2.make_squares(16, generator=torch.Generator().manual_seed(7))
    assert (again[0] == imgs).all() and (again[1] == labels).all()


def test_finalize_cam_2d_matches_jax_and_thresholds():
    cam = np.random.default_rng(0).normal(size=(2, 14, 14)).astype(np.float32)
    got = v2.finalize_cam_2d(torch.from_numpy(cam), SIZE, 20.0).numpy()
    want = np.asarray(jv.finalize_cam_2d(jnp.asarray(cam), SIZE, 20.0))
    assert got.shape == (2, SIZE, SIZE)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert 0.0 <= got.min() and got.max() <= 1.0 + 1e-6
    # The top 20 % of the 14x14 grid are kept before the upsample.
    assert (v2.finalize_cam_2d(torch.from_numpy(cam), 14, 20.0).numpy()
            > 0).mean() < 0.3


def test_show_cam_on_image_contract():
    """uint8 [H, W, 3] scaled by its max, and equal to JAX's (matplotlib's
    jet) to one step of the uint8 rounding."""
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    cam = rng.uniform(size=(SIZE, SIZE)).astype(np.float32)
    cam[0, :3] = (0.0, 1.0, 0.5)
    out = v2.show_cam_on_image(rgb, cam)
    assert out.shape == (SIZE, SIZE, 3) and out.dtype == np.uint8
    assert out.max() == 255
    want = jv.show_cam_on_image(rgb, cam)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_png_and_load_image_round_trip(tmp_path):
    """write_png's file reads back as written, and _load_image of it
    equals JAX's, shrinking (antialiased) and enlarging."""
    rng = np.random.default_rng(1)
    for shape in ((100, 80), (30, 40)):
        rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        path = str(tmp_path / f"img{shape[0]}.png")
        v2.write_png(path, rgb)
        back = mpimg.imread(path)
        assert back.shape == shape + (3,)
        np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8),
                                      rgb)
        np.testing.assert_allclose(v2._load_image(path, SIZE),
                                   jv._load_image(path, SIZE), atol=1e-5)


def test_cli_writes_png(tmp_path, capsys):
    out = v2.main(["--method", "layercam", "--steps", "2", "--device", "cpu",
                   "--output-dir", str(tmp_path)])
    assert out == str(tmp_path / "layercam_cam.png")
    img = mpimg.imread(out)
    assert img.shape == (SIZE, SIZE, 3)
    said = capsys.readouterr().out
    assert "Synthetic sample: square at cell" in said
    assert "Predicted class:" in said and "Saved" in said
