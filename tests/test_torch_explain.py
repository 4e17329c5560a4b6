"""The port's integrated gradients, Kernel SHAP, B-cos and Grad-CAM driver
(plain PyTorch on the CPU) against the JAX package, on the tiny 3D ViT of
tests/test_torch_gradcam.py (grid 20, patch 5, dim 64, depth 2, 4 heads of
16, f32, the same weights through ``from_jax_params``).

Tolerances: attributions within 1e-4 of their largest magnitude (the
gradients of two f32 models, summed in another order); the completeness
gap within 1e-3 (a ratio of such sums); Shapley values within 1e-3 of
their largest magnitude (a least-squares solve of scores equal to 1e-6);
B-cos outputs at 1e-5 abs + 1e-4 rel.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from neurovit_tpu.data import nifti
from neurovit_tpu.data.synthetic import GradCAMDataset
from neurovit_tpu.explainability import bcos as jbcos
from neurovit_tpu.explainability import driver as jdriver
from neurovit_tpu.explainability import integrated_gradients as jig
from neurovit_tpu.explainability import shap_values as jshap
from neurovit_tpu_torch.explainability import (bcos, driver,
                                               integrated_gradients, shap_values)
from neurovit_tpu_torch.training import state_dict as sd
from test_torch_gradcam import GRID, close_scaled, model_pair, volumes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=5, GRADCAM_SLICE_IDX=10)


@pytest.mark.parametrize("batch", [1, 2])
def test_integrated_gradients_matches_jax(pair, batch):
    jmodel, params, model = pair
    x = volumes(31, batch)
    x = x[0] if batch == 1 else x
    baseline = volumes(32, 1)[0]
    want, want_cls = jig.integrated_gradients(
        jmodel, {"params": params}, x, baseline=baseline, steps=8)
    got, got_cls = integrated_gradients.integrated_gradients(
        model, x, baseline=baseline, steps=8)
    assert got.shape == x.shape
    assert got_cls.tolist() == np.asarray(want_cls).tolist()
    close_scaled(got, want)


def test_completeness_gap_matches_jax(pair):
    jmodel, params, model = pair
    x, baseline = volumes(33, 1)[0], volumes(34, 1)[0]
    want = jig.completeness_gap(jmodel, {"params": params}, x, steps=64,
                                baseline=baseline)
    got = integrated_gradients.completeness_gap(model, x, steps=64,
                                                baseline=baseline)
    assert abs(got - want) < 1e-3, (got, want)
    assert got < 0.05


def test_kernel_shap_matches_jax(pair):
    """The same coalitions from the same seed, the same Shapley values."""
    jmodel, params, model = pair
    x = volumes(35, 1)[0]
    kw = dict(region_size=10, nsamples=48, batch_size=16, seed=3)
    want, want_cls = jshap.kernel_shap(jmodel, {"params": params}, x, **kw)
    got, got_cls = shap_values.kernel_shap(model, x, **kw)
    assert got.shape == x.shape and got_cls == want_cls
    close_scaled(got, want, rel=1e-3)


def test_kernel_shap_refuses_a_region_that_does_not_tile(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="must divide"):
        shap_values.kernel_shap(model, volumes(36, 1)[0], region_size=8)


def test_shapley_kernel_weights_stay_exact():
    """The port's weights equal JAX's, and stay finite and positive where
    JAX's float32 product overflows (m = 125, coalitions of about 62)."""
    sizes = np.array([0, 1, 3, 7, 8], np.float32)
    np.testing.assert_allclose(shap_values._shapley_kernel_weights(8, sizes),
                               jshap._shapley_kernel_weights(8, sizes))
    mid = shap_values._shapley_kernel_weights(125, np.array([62.0],
                                                            np.float32))
    assert 0 < mid[0] < 1e-30


def _torch_bcos(params):
    return [{"kernel": torch.from_numpy(np.array(p["kernel"]))}
            for p in params]


@pytest.mark.parametrize("b", [1.0, 2.0, 2.5])
def test_bcos_layers_and_exact_explanations_match_jax(b):
    rng = np.random.default_rng(0)
    jparams = jbcos.init_bcos_mlp(jax.random.key(0), [30, 16, 3])
    params = _torch_bcos(jparams)
    x = rng.standard_normal((4, 30)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        bcos.bcos_mlp_apply(params, xt, b=b).numpy(),
        np.asarray(jbcos.bcos_mlp_apply(jparams, x, b=b)),
        rtol=1e-4, atol=1e-5)
    contrib, cls, logits = bcos.explain_exact(params, xt, b=b)
    j_contrib, j_cls, _ = jbcos.explain_exact(jparams, x, b=b)
    assert cls.tolist() == np.asarray(j_cls).tolist()
    np.testing.assert_allclose(contrib.numpy(), np.asarray(j_contrib),
                               rtol=1e-4, atol=1e-5)
    # Completeness is an identity: the contributions sum to the logit.
    np.testing.assert_allclose(contrib.sum(dim=1).numpy(),
                               logits.gather(1, cls[:, None])[:, 0].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_bcos_init_and_volume_inputs():
    gen = torch.Generator().manual_seed(1)
    params = bcos.init_bcos_mlp(gen, [30, 8, 2])
    assert [tuple(p["kernel"].shape) for p in params] == [(30, 8), (8, 2)]
    assert float(params[0]["kernel"].abs().max()) <= 30 ** -0.5
    vol = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 5, 3, 2)).astype(np.float32))
    contrib, _, logits = bcos.explain_exact(params, vol)
    assert contrib.shape == vol.shape
    np.testing.assert_allclose(contrib.reshape(2, -1).sum(dim=1).numpy(),
                               logits.max(dim=1).values.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_grad_times_input_matches_jax(pair):
    jmodel, params, model = pair
    x = volumes(37, 2)
    want, want_cls = jbcos.explain(jmodel, {"params": params}, x)
    got, got_cls = bcos.explain(model, x)
    assert got_cls.tolist() == np.asarray(want_cls).tolist()
    close_scaled(got, want)
    one, _ = bcos.explain(model, x[1])
    np.testing.assert_allclose(one, got[1], rtol=1e-5, atol=1e-7)


def _driver_config(tiny_config, tmp_path, **extra):
    return dict(tiny_config, GRADCAM_TRAIN_PATH=None, GRADCAM_VAL_PATH=None,
                GRADCAM_OUTPUT_DIR=str(tmp_path / "cams"),
                GRADCAM_SLICE_IDX=10, TRAINING_SEED=5, **extra)


def test_driver_writes_png_and_nifti(pair, tiny_config, tmp_path):
    """The combined PNG, and with GRADCAM_SAVE_ATTENTION each sample's 3D
    scatter PNG and its map as NIfTI; the slices and classes are JAX's."""
    jmodel, params, model = pair
    config = _driver_config(tiny_config, tmp_path)
    dataset = GradCAMDataset(config, "val")
    png = driver.create_gradcam_plot(model, dataset, [0, 1], config,
                                     save_sample_attention=True)
    assert os.path.exists(png)
    for sid in (0, 1):
        stem = os.path.join(config["GRADCAM_OUTPUT_DIR"],
                            f"ADNI_5patch_3Dattention_{sid}")
        assert os.path.exists(stem + ".png")
        saved = nifti.load(stem + ".nii").get_fdata(np.float32)
        cam, _ = model.get_attention_map(dataset.sample(sid)["volume"])
        np.testing.assert_array_equal(saved, cam)
        _, img, attn, cls, _ = driver.get_sample_gradcam(model, dataset, sid,
                                                         config)
        _, j_img, j_attn, j_cls, _ = jdriver.get_sample_gradcam(
            jmodel, {"params": params}, dataset, sid, config)
        assert cls == j_cls
        np.testing.assert_array_equal(img, j_img)
        np.testing.assert_allclose(attn, j_attn, atol=1e-4)


def test_driver_menu_method(pair, tiny_config, tmp_path):
    _, _, model = pair
    config = _driver_config(tiny_config, tmp_path, GRADCAM_METHOD="layercam")
    dataset = GradCAMDataset(config, "val")
    sid, img, attn, cls, _ = driver.get_sample_gradcam(model, dataset, 2,
                                                       config)
    from neurovit_tpu_torch.explainability.cam_methods import compute_cam
    cam, idx = compute_cam(model, dataset.sample(2)["volume"],
                           method="layercam")
    assert sid == 2 and cls == int(idx[0])
    np.testing.assert_array_equal(attn, cam[:, :, 10])
    assert img.shape == attn.shape == (GRID, GRID)


def _write_config(config, tmp_path):
    path = tmp_path / "cam.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def test_driver_main_on_the_cpu_plain_path(pair, tiny_config, tmp_path):
    """``python -m neurovit_tpu_torch.explainability.driver --device cpu``:
    the weights at BEST_MODEL_PATH load, twelve samples are plotted."""
    _, _, model = pair
    best = tmp_path / "best.pkl"
    sd.save(str(best), model.state_dict())
    config = _driver_config(tiny_config, tmp_path, GLOBAL_BASE_PATH="/",
                            BEST_MODEL_PATH=str(best))
    driver.main(["--device", "cpu", "--wandb", "false",
                 "--config", _write_config(config, tmp_path)])
    pngs = [f for f in os.listdir(config["GRADCAM_OUTPUT_DIR"])
            if f.endswith(".png")]
    assert len(pngs) == 1 and pngs[0].startswith("ADNI_5patch_results_")


def test_driver_main_needs_a_card_unless_told_cpu(tiny_config, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    config = _driver_config(tiny_config, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["--wandb", "false",
                     "--config", _write_config(config, tmp_path)])
