"""The port's 3D ResNet against the JAX package's, on the same weights
(``from_jax_params``) and numpy-seeded inputs: the model in train and eval
mode, its gradients, the Trainer, the CAMs, the Predictor, the state-dict
interchange, the CLIs and both CAM drivers, on the CPU plain path.

The JAX side runs its Pallas pool (``NEUROVIT_MAXPOOL=pallas``, interpret
mode on the CPU), whose tie routing the port keeps; XLA's default pool
splits ties another way and is held to the port only on tie-free f32
inputs.

Tolerances, with their reasons:

- f32 eval: 1e-5 abs + 1e-4 rel (the same convs and rounding points).
- f32 train mode: 2e-3 of the largest magnitude. Batch statistics divide
  by a standard deviation taken over few elements per channel, and JAX's
  CPU reductions sum sequentially where torch's sum pairwise; against f64,
  JAX's f32 logits are off by 5e-4 of their magnitude and torch's by 4e-5
  (a [4, 40, 40, 16] batch at depth 50).
- bf16: 5e-2 of the largest magnitude, as tests/test_torch_train.py (the
  same rounding points; an ulp now and then).
- The model tests run on [4, 40, 40, 16] volumes: at 16^3 a batch of two
  has layer4 at 1x1x1, and train-mode statistics of two values are so
  ill-conditioned that at depth 50 torch's own f32 and f64 logits differ
  by half their magnitude, and in bf16 one ulp of a conv output moves a
  logit by a fifth.
"""

import glob
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from neurovit_tpu.explainability import gradcam_resnet as jax_cam
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.models import resnet3d as jax_resnet
from neurovit_tpu.parallel import create_mesh, shard_batch
from neurovit_tpu.serving import Predictor as JaxPredictor
from neurovit_tpu.training import Trainer as JaxTrainer
from neurovit_tpu.training import checkpoint as jax_ckpt
from neurovit_tpu.training import state_dict as jax_sd
from neurovit_tpu_torch import serving, serving_http
from neurovit_tpu_torch.config import load_config
from neurovit_tpu_torch.data import nifti
from neurovit_tpu_torch.explainability import (driver_resnet, driver_smri,
                                               gradcam_resnet)
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.models.neuro_encoder import ResNet3DEncoder
from neurovit_tpu_torch.models import resnet3d
from neurovit_tpu_torch.ops import maxpool3d
from neurovit_tpu_torch.serving import Predictor
from neurovit_tpu_torch.training import Trainer
from neurovit_tpu_torch.training import state_dict as sd
from neurovit_tpu_torch.training.trainer import check_supported

torch.set_num_threads(1)

PREFIX = "resnet_3d.resnet."
BATCH = 4


@pytest.fixture(autouse=True)
def pallas_pool(monkeypatch):
    monkeypatch.setenv("NEUROVIT_MAXPOOL", "pallas")


def _config(tmp_path, **extra):
    return load_config(overrides={
        "MODEL_VOLUME_ENCODER": "resnet", "MODEL_RESNET_DEPTH": 10,
        "TRAINING_VIT_INPUT_SIZE": 16, "TRAINING_VIT_PATCH_SIZE": 4,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32",
        "TRAINING_BATCH_SIZE": BATCH, "TRAINING_NUM_WORKERS": 2,
        "TRAINING_EPOCHS": 2, "TRAINING_LEARNING_RATE": 1e-3,
        "KERNEL_IMPL": "xla", "WANDB_ENABLED": False,
        "GLOBAL_OUTPUT_DIR": str(tmp_path / "runs"), **extra})


def _close(got, want, tol: float):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(
        float(np.abs(want).max()), 1e-6))


def _variables(tree, seed: int):
    """JAX ResNet variables with the BN state moved off its init."""
    rng = np.random.default_rng(seed)
    state = jax.tree.map(lambda a: jnp.asarray(
        0.5 + np.abs(rng.standard_normal(a.shape)).astype(np.float32)),
        tree["state"])
    return {"params": tree["params"], "state": state}


def _port_cfg(cfg):
    """The port's ResNetConfig of a JAX one (the JAX stem options at their
    defaults, the only stem the port builds)."""
    assert (cfg.conv1_t_size, cfg.conv1_t_stride, cfg.no_max_pool) == (
        7, 1, False)
    return resnet3d.ResNetConfig(
        depth=cfg.depth, n_input_channels=cfg.n_input_channels,
        shortcut_type=cfg.shortcut_type, widen_factor=cfg.widen_factor,
        n_classes=cfg.n_classes)


def _port(cfg, variables):
    """The port's ResNet3D with the JAX variables."""
    model = resnet3d.ResNet3D(_port_cfg(cfg))
    full = sd.from_jax_params({"params": {"volume_encoder":
                                          variables["params"]},
                               "state": {"volume_encoder":
                                         variables["state"]}})
    model.load_state_dict({k[len(PREFIX):]: v for k, v in full.items()},
                          strict=True)
    return model, full


def _stats(model):
    return {k: v for k, v in model.state_dict().items() if "running" in k}


# The model input [B, 1, D, H, W] of the model tests: layer4 is 1x2x2.
INPUT = (4, 1, 16, 40, 40)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("depth,shortcut", [(10, "A"), (50, "B")])
def test_logits_and_bn_state_match_jax(depth, shortcut, dtype):
    """Eval and train mode: logits, and in train mode every new running
    mean and variance, against resnet3d.apply with the Pallas pool. Depth
    50 in bf16 is held in eval mode only: in train mode at this init its
    bf16 logits differ from its f32 logits by 25 % (torch) and 31 % (JAX)
    of their magnitude, so neither side is a reference for the other."""
    cfg = jax_resnet.ResNetConfig(depth=depth, n_input_channels=1,
                                  n_classes=3, widen_factor=0.25,
                                  shortcut_type=shortcut)
    variables = _variables(jax_resnet.init(jax.random.PRNGKey(depth), cfg),
                           seed=depth)
    x = np.random.default_rng(3).standard_normal(INPUT).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    for train in (False, True)[:1 if (depth, dtype) == (50, "bf16") else 2]:
        model, _ = _port(cfg, variables)
        want, new_state = jax_resnet.apply(
            variables["params"], variables["state"],
            jnp.asarray(x).astype(jdt), cfg, train=train)
        with torch.no_grad():
            got = model(torch.from_numpy(x).to(tdt), train=train)
        assert got.dtype == torch.float32 and got.shape == (x.shape[0], 3)
        tol = 5e-2 if dtype == "bf16" else 2e-3 if train else None
        if tol is None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
        else:
            _close(got.numpy(), want, tol)
        _, full = _port(cfg, {"params": variables["params"],
                              "state": new_state})
        for key, value in _stats(model).items():
            want_stat = full[PREFIX + key].numpy()
            if train:
                _close(value.numpy(), want_stat, 5e-2 if dtype == "bf16"
                       else 2e-3)
            else:
                np.testing.assert_array_equal(value.numpy(), want_stat)


def test_xla_pool_agrees_on_tie_free_f32(monkeypatch):
    """JAX's default (XLA reduce_window) pool: the same logits and
    gradients as the port's on tie-free f32 volumes (ties left after the
    stem's ReLU are zeros, whose gradient dies in the ReLU backward)."""
    monkeypatch.setenv("NEUROVIT_MAXPOOL", "xla")
    cfg = jax_resnet.ResNetConfig(depth=10, n_input_channels=1, n_classes=2,
                                  widen_factor=0.25, shortcut_type="B")
    variables = _variables(jax_resnet.init(jax.random.PRNGKey(1), cfg), 1)
    n = 2 * 16 ** 3
    x = (np.random.default_rng(4).permutation(n) / n).astype(
        np.float32).reshape(2, 1, 16, 16, 16)
    want = jax_resnet.apply(variables["params"], variables["state"],
                            jnp.asarray(x), cfg)[0]
    model, _ = _port(cfg, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_runs_without_tf32_and_matches_autograd(monkeypatch, dtype):
    """The port's conv turns cuDNN's TF32 flag off in its forward and in
    its backward, which autograd runs after the forward has returned, and
    leaves the flag as it found it; its gradients are F.conv3d's own."""
    seen = []

    class spy:
        """Records the flag at each call; other attributes (an op's
        ``.default``) are the wrapped function's."""

        def __init__(self, name, fn):
            self.name, self.fn = name, fn

        def __call__(self, *args, **kwargs):
            seen.append((self.name, torch.backends.cudnn.allow_tf32))
            return self.fn(*args, **kwargs)

        def __getattr__(self, attr):
            return getattr(self.fn, attr)

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 7, 8, 9, generator=gen).to(dtype)
    w = torch.randn(5, 3, 3, 3, 3, generator=gen)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [w.clone().requires_grad_() for _ in range(2)]
    F.conv3d(xs[1], ws[1].to(dtype), stride=(1, 2, 2), padding=1).float(
        ).square().sum().backward()
    monkeypatch.setattr(F, "conv3d", spy("forward", F.conv3d))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward",
                        spy("backward", torch.ops.aten.convolution_backward))
    assert torch.backends.cudnn.allow_tf32
    resnet3d.conv3d(xs[0], ws[0], (1, 2, 2), 1).float().square().sum(
        ).backward()
    assert seen == [("forward", False), ("backward", False)]
    assert torch.backends.cudnn.allow_tf32
    torch.testing.assert_close(xs[0].grad, xs[1].grad, rtol=0, atol=0)
    torch.testing.assert_close(ws[0].grad, ws[1].grad, rtol=0, atol=0)


@pytest.mark.parametrize("shortcut", ["A", "B"])
def test_parameter_gradients_match_jax_grad(shortcut):
    """Train mode, f32: d(sum(logits * w))/dparams against jax.grad, within
    1e-4 of each gradient's largest magnitude (both sides are within 1e-5
    of an f64 computation)."""
    cfg = jax_resnet.ResNetConfig(depth=10, n_input_channels=1, n_classes=3,
                                  widen_factor=0.25, shortcut_type=shortcut)
    variables = _variables(jax_resnet.init(jax.random.PRNGKey(2), cfg), 2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(INPUT).astype(np.float32)
    w = rng.standard_normal((INPUT[0], 3)).astype(np.float32)

    def loss(p):
        logits, _ = jax_resnet.apply(p, variables["state"], jnp.asarray(x),
                                     cfg, train=True)
        return jnp.sum(logits * w)

    grads = jax.grad(loss)(variables["params"])
    want, _ = _port(cfg, {"params": grads, "state": variables["state"]})
    model, _ = _port(cfg, variables)
    (model(torch.from_numpy(x), train=True) * torch.from_numpy(w)).sum(
        ).backward()
    wanted = dict(want.named_parameters())
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), wanted[name].detach().numpy(), 1e-4)


# Trainer volumes [H, W, D]: layer4 1x2x2, well-conditioned statistics.
VOLUME = (40, 40, 16)


class _Volumes:
    """A fixed dataset the Trainers can build their loaders on."""

    def __len__(self):
        return 4 * BATCH

    def sample(self, idx):
        rng = np.random.RandomState(idx)
        return {"volume": rng.randn(*VOLUME).astype(np.float32),
                "label": idx % 2, "subject": f"s{idx}", "timepoint": 0}


def _batches(n):
    rng = np.random.RandomState(7)
    return [{"volume": rng.randn(BATCH, *VOLUME).astype(np.float32),
             "label": rng.randint(0, 2, BATCH).astype(np.int32),
             "valid": np.arange(BATCH) < BATCH - i}    # a padding row
            for i in range(n)]


def _jax_to_port(jmodel, params, state):
    return {k: torch.from_numpy(np.array(v)) for k, v in jax_sd.to_state_dict(
        jmodel, jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, state)).items()}


def _narrow(jmodel, model):
    """Both NeuroEncoders at widen 0.25 (the config fixes widen 1): there
    the JAX package's f32 gradients are within 1e-5 of an f64 computation,
    where at widen 1 its sequential CPU sums are off by up to 1.5e-2 of a
    gradient's magnitude, which Adam's first steps turn into sign flips."""
    jmodel.resnet_cfg = jax_resnet.ResNetConfig(
        depth=10, n_input_channels=1, n_classes=2, widen_factor=0.25)
    model.resnet_cfg = _port_cfg(jmodel.resnet_cfg)
    model.resnet_3d = ResNet3DEncoder(model.resnet_cfg)


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_steps_match_jax(tmp_path, accum):
    """Two micro-steps of each Trainer (the second batch with a padding
    row, which the batch statistics include): loss, the updated
    parameters and the running stats, which move in every micro-step;
    then an eval forward on the running stats. f32, within 1e-5 abs +
    1e-4 rel (the guide of tests/test_torch_train.py), but for the rare
    parameter whose gradient is lost in f32 noise (below)."""
    config = _config(tmp_path, TRAINING_ACCUMULATION_STEP=accum)
    jmodel = JaxNeuroEncoder(config)
    model = NeuroEncoder(config, device="cpu")
    _narrow(jmodel, model)
    mesh = create_mesh(config, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(config, jmodel, _Volumes(), _Volumes(), mesh=mesh)
    ts = jtrainer.train_state
    model.load_state_dict(_jax_to_port(jmodel, ts["params"],
                                       ts["model_state"]), strict=True)
    trainer = Trainer(config, model, _Volumes(), _Volumes())
    for b in _batches(2):
        jb = shard_batch(jtrainer._device_batch(b)[0], mesh)
        jtrainer.train_state, jm = jtrainer._train_step(jtrainer.train_state,
                                                        jb)
        m = trainer.train_step({"volume": torch.from_numpy(b["volume"]),
                                "label": torch.from_numpy(b["label"]).long(),
                                "valid": torch.from_numpy(b["valid"])})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, atol=1e-5)
        assert int(m["count"]) == int(jm["count"])
    ts = jtrainer.train_state
    want = _jax_to_port(jmodel, ts["params"], ts["model_state"])
    flips, total = 0, 0
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 2
            continue
        # A gradient element below f32 noise of its sum can take Adam's
        # first step, +-lr, either way: such elements may differ by up to
        # lr per optimizer step; at most 1e-4 of them.
        diff = np.abs(value.numpy() - want[key].numpy())
        bad = diff > 1e-5 + 1e-4 * np.abs(want[key].numpy())
        assert (diff[bad] <= 2 * config["TRAINING_LEARNING_RATE"]).all(), key
        flips, total = flips + int(bad.sum()), total + diff.size
    assert flips <= 1e-4 * total
    b = _batches(1)[0]
    jl, _ = jmodel.apply(ts["params"], jnp.asarray(b["volume"]),
                         state=ts["model_state"])
    with torch.no_grad():
        got = model(torch.from_numpy(b["volume"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)


def test_resume_restores_running_stats(tmp_path):
    """The train state and the weight file carry the running stats; a
    restored Trainer's next step equals the uninterrupted one."""
    from neurovit_tpu_torch.training import checkpoint as ckpt
    config = _config(tmp_path)
    b1, b2 = ({"volume": torch.from_numpy(b["volume"]),
               "label": torch.from_numpy(b["label"]).long(),
               "valid": torch.from_numpy(b["valid"])} for b in _batches(2))
    trainer = Trainer(config, NeuroEncoder(config, device="cpu"), _Volumes(),
                      _Volumes())
    trainer.train_step(b1)
    path = str(tmp_path / "state")
    ckpt.save_train_state(path, trainer._checkpoint_state(), trainer.model)
    weights = sd.load(path + ".state_dict.pkl")
    stats = _stats(trainer.model)
    assert stats and all(torch.equal(weights[k], v)
                         for k, v in stats.items())
    want = float(trainer.train_step(b2)["loss"])
    other = Trainer(config, NeuroEncoder(config, device="cpu", seed=3),
                    _Volumes(), _Volumes())
    other.restore(path)
    assert float(other.train_step(b2)["loss"]) == want
    for (k, v), w in zip(other.model.state_dict().items(),
                         trainer.model.state_dict().values()):
        assert torch.equal(v, w), k


@pytest.fixture(scope="module")
def cam_pair():
    config = load_config(overrides={
        "MODEL_VOLUME_ENCODER": "resnet", "MODEL_RESNET_DEPTH": 10,
        "TRAINING_VIT_INPUT_SIZE": 16, "TRAINING_VIT_PATCH_SIZE": 4,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32"})
    jmodel = JaxNeuroEncoder(config)
    variables = _variables(jmodel.init(jax.random.key(3)), 3)
    model = NeuroEncoder(config, device="cpu")
    model.load_state_dict(_jax_to_port(jmodel, variables["params"],
                                       variables["state"]), strict=True)
    return jmodel, variables, model


def test_capture_features_and_feature_shift_match_jax(cam_pair):
    """The CAM's layer4 probe (``layer4_acts_grads``) against
    apply(capture_features=True, feature_shift=...): the logits, the
    argmax classes, the layer4 features and the gradient of each volume's
    argmax-class logit with respect to the shift, f32, eval mode."""
    jmodel, variables, model = cam_pair
    x = np.random.default_rng(12).standard_normal(
        (2, 34, 34, 18)).astype(np.float32)
    vol = jnp.asarray(x.transpose(0, 3, 1, 2)[:, None])
    params = variables["params"]["volume_encoder"]
    state = variables["state"]["volume_encoder"]
    shape = (2, 512, 2, 2, 2)

    def logit(shift, cls):
        logits, _, feats = jax_resnet.apply(
            params, state, vol, jmodel.resnet_cfg, capture_features=True,
            feature_shift=shift)
        return logits[jnp.arange(2), cls].sum(), (logits, feats)

    want_logits = jax_resnet.apply(params, state, vol, jmodel.resnet_cfg)[0]
    want_cls = np.asarray(want_logits).argmax(1)
    (_, (_, want_feats)), want_grad = jax.value_and_grad(
        logit, has_aux=True)(jnp.zeros(shape), want_cls)
    logits, cls, feats, grad = gradcam_resnet.layer4_acts_grads(
        model, torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-5)
    assert cls.tolist() == want_cls.tolist()
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("method", gradcam_resnet.METHODS)
def test_cams_match_jax(cam_pair, method):
    """[2, 34, 34, 18] volumes give a 2x2x2 layer4: the maps, upsampled to
    the volume with JAX's edges, and the classes. The CAM runs the pool's
    forward and no backward kernel's plain path."""
    jmodel, variables, model = cam_pair
    x = np.random.default_rng(6).standard_normal(
        (2, 34, 34, 18)).astype(np.float32)
    want, want_cls = jax_cam.resnet_cam(jmodel, variables, x, method=method)
    got, cls = gradcam_resnet.resnet_cam(model, x, method=method)
    assert got.shape == (2, 34, 34, 18) and cls.tolist() == want_cls.tolist()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    one, _ = gradcam_resnet.resnet_cam(model, x[0], method=method)
    np.testing.assert_allclose(one, got[0], rtol=0, atol=1e-5)


def test_predictor_matches_jax_predictor(cam_pair, tmp_path):
    """A checkpoint the JAX package wrote, served by both Predictors."""
    jmodel, variables, _ = cam_pair
    path = str(tmp_path / "resnet.state_dict.pkl")
    jax_sd.save(path, jax_sd.to_state_dict(jmodel, variables["params"],
                                           variables["state"]))
    config = jmodel.config
    vols = np.random.default_rng(8).standard_normal(
        (3, 16, 16, 16)).astype(np.float32)
    _, want = JaxPredictor.from_checkpoint(config, path, batch_size=4)(vols)
    labels, got = Predictor.from_checkpoint(config, path, batch_size=4,
                                            device="cpu")(vols)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert labels.tolist() == want.argmax(1).tolist()
    with pytest.raises(ValueError, match="ViT volume encoder only"):
        Predictor.from_checkpoint(config, path, device="cpu", quant="int8")


def test_state_dict_round_trips(cam_pair, tmp_path):
    """JAX's export loads with strict=True and equals from_jax_params; the
    port's save loads strictly into JAX variables and gives its logits."""
    jmodel, variables, model = cam_pair
    exported = jax_sd.to_state_dict(jmodel, variables["params"],
                                    variables["state"])
    mine = sd.from_jax_params({"params": variables["params"],
                               "state": variables["state"]})
    assert sorted(exported) == sorted(mine)
    for key, value in exported.items():
        np.testing.assert_array_equal(mine[key].numpy(), np.asarray(value))
    path = str(tmp_path / "jax.pkl")
    jax_sd.save(path, exported)
    fresh = NeuroEncoder(jmodel.config, device="cpu", seed=9)
    fresh.load_state_dict(sd.load(path), strict=True)

    # A port model whose BN state moved, saved by the port, read by JAX.
    trained = NeuroEncoder(jmodel.config, device="cpu", seed=4)
    with torch.no_grad():
        trained(torch.randn(4, 16, 16, 16), train=True)
    path = str(tmp_path / "port.pkl")
    sd.save(path, trained.state_dict())
    back = jax_ckpt.load_variables_file(
        jmodel, jmodel.init(jax.random.key(0)), path, strict=True)
    vols = np.random.default_rng(9).standard_normal(
        (2, 16, 16, 16)).astype(np.float32)
    want, _ = jmodel.apply(back["params"], jnp.asarray(vols),
                           state=back["state"])
    with torch.no_grad():
        got = trained(torch.from_numpy(vols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_cpu_path_counts_no_launch_and_cam_runs_no_backward(cam_pair):
    jmodel, variables, model = cam_pair
    counted = (maxpool3d.max_pool3d_argmax_cuda,
               maxpool3d.max_pool3d_argmax_bwd_cuda)
    before = [fn.launches for fn in counted]
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 34, 34, 18)).astype(np.float32))
    # The CAM's body records no graph for a volume that needs no gradient.
    _, _, acts, grads = gradcam_resnet.layer4_acts_grads(model, x)
    assert acts.shape == grads.shape == (2, 512, 2, 2, 2)
    x.requires_grad_()
    _, _, _, grads2 = gradcam_resnet.layer4_acts_grads(model, x)
    torch.testing.assert_close(grads2, grads)
    assert [fn.launches for fn in counted] == before == [0, 0]


def test_check_supported_refuses_f32_on_cuda_for_the_vit_only(tmp_path):
    """At f32 on CUDA the trainer takes the ResNet, the 3D ViT (its
    backward kernels have f32 instances), a 4D model and its int8 encoder
    (K10-K13 have f32 instances): of the ViT it refuses nothing at f32
    any more."""
    cuda = torch.device("cuda")
    check_supported(_config(tmp_path), cuda)
    check_supported(_config(tmp_path, MODEL_VOLUME_ENCODER="vit",
                            TRAINING_DIM=4), cuda)
    check_supported(_config(tmp_path, MODEL_VOLUME_ENCODER="vit"), cuda)
    check_supported(_config(tmp_path, MODEL_VOLUME_ENCODER="vit",
                            TRAINING_DIM=4,
                            TRAINING_4D_ENCODER_QUANT="int8"), cuda)


def _write_yaml(tmp_path, config) -> str:
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(dict(config)))
    return str(path)


def test_main_trains_and_infers(tmp_path, monkeypatch):
    """``python -m neurovit_tpu_torch.main --device cpu`` trains the ResNet
    for an epoch and runs ``--inference`` on its weights."""
    from neurovit_tpu_torch import main as port_main
    monkeypatch.chdir(tmp_path)
    config = _config(tmp_path, DATASET_NAME="gradcam", DATASET_GENERATE=True,
                     GRADCAM_NUM_SAMPLES=20, TRAINING_EPOCHS=1,
                     GRADCAM_TRAIN_PATH=str(tmp_path / "tr.pkl"),
                     GRADCAM_VAL_PATH=str(tmp_path / "va.pkl"),
                     BEST_MODEL_PATH=str(tmp_path / "best.pkl"))
    cfg = _write_yaml(tmp_path, config)
    port_main.main(["--device", "cpu", "--wandb", "false", "--config", cfg])
    pkl = glob.glob(os.path.join(config["GLOBAL_OUTPUT_DIR"], "*",
                                 "model-e0.state_dict.pkl"))
    weights = sd.load(pkl[0])
    assert int(weights[PREFIX + "bn1.num_batches_tracked"]) == 4
    os.replace(pkl[0], tmp_path / "best.pkl")
    port_main.main(["--inference", "--device", "cpu", "--wandb", "false",
                    "--config", cfg])


def test_serving_clis(cam_pair, tmp_path):
    """The batch CLI writes the Predictor's rows; the HTTP server answers
    one /predict with them; ``--quant int8`` is refused."""
    jmodel, variables, model = cam_pair
    ckpt = str(tmp_path / "model.pt")
    sd.save(ckpt, model.state_dict())
    cfg = _write_yaml(tmp_path, dict(jmodel.config,
                                     BEST_MODEL_PATH=ckpt))
    scan = str(tmp_path / "scan.nii")     # the ADNI crop gives 16^3
    nifti.save(scan, np.random.default_rng(11).standard_normal(
        (17, 35, 17)).astype(np.float32))
    out = tmp_path / "pred.csv"
    serving.main([scan, "--config", cfg, "--output", str(out),
                  "--batch-size", "2", "--device", "cpu"])
    rows = out.read_text().strip().splitlines()
    predictor = Predictor.from_checkpoint(jmodel.config, ckpt, batch_size=2,
                                          device="cpu")
    vol = next(serving._collect_volume_jobs([scan], crop=True))[2]
    _, want = predictor(vol[None])
    np.testing.assert_allclose([float(p) for p in rows[1].split(",")[3:]],
                               want[0], atol=1e-5)

    server, batcher = serving_http.make_server(predictor, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=open(scan, "rb").read(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            row = json.loads(resp.read())["rows"][0]
        np.testing.assert_allclose(row["probs"], want[0], atol=1e-6)
    finally:
        server.shutdown()
        batcher.stop()
        thread.join(timeout=10)
        server.server_close()
    with pytest.raises(ValueError, match="ViT volume encoder only"):
        serving_http.main(["--config", cfg, "--device", "cpu", "--quant",
                           "int8", "--no-warmup"])


def test_drivers_write_png_and_nifti(tmp_path):
    """driver_resnet and driver_smri on the CPU (``main`` with ``--device
    cpu``): the PNG grid and overlays, and the NIfTI heatmaps in [0, 1] of
    the volumes' shapes."""
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(0)
    rows = []
    for i in range(2):
        path = str(tmp_path / f"s{i}.nii")
        nifti.save(path, rng.randn(24, 30, 26).astype(np.float32))
        rows.append({"ID": i, "Subject": f"S{i:03d}", "Group": "CN",
                     "Sex": "F", "Age": 70, "Path_fMRI_brain": "",
                     "Path_sMRI_brain": path})
    csv = str(tmp_path / "manifest.csv")
    pd.DataFrame(rows).to_csv(csv, index=False)
    out_dir = tmp_path / "out"
    ckpt = str(tmp_path / "best.pkl")
    # The synthetic cube dataset (8 classes at grid 16, cube 8) feeds
    # driver_resnet; its 12 validation samples are the grid's.
    config = _config(tmp_path, DATASET_NAME="gradcam",
                     GRADCAM_TRAIN_PATH=None, GRADCAM_VAL_PATH=None,
                     GRADCAM_NUM_SAMPLES=60, GRADCAM_SLICE_IDX=8,
                     GRADCAM_OUTPUT_DIR=str(out_dir),
                     GRADCAM_SAVE_ATTENTION=True, BEST_MODEL_PATH=ckpt,
                     ADNI_CSV_PATH=csv, GRADCAM_SMRI_Z_CROP=[2, 24])
    sd.save(ckpt, NeuroEncoder(config, device="cpu", seed=5).state_dict())
    args = ["--device", "cpu", "--wandb", "false", "--config",
            _write_yaml(tmp_path, config)]
    driver_resnet.main(args)
    assert len(glob.glob(str(out_dir / "resnet_layercam_results_*.png"))) == 1
    for sid in (0, 11):
        heat = nifti.load(str(out_dir / f"resnet_layercam_heatmap{sid}.nii")
                          ).get_fdata(np.float32)
        assert heat.shape == (16, 16, 16)
        assert heat.min() >= 0 and heat.max() <= 1 + 1e-6
    driver_smri.main(args)
    assert len(glob.glob(str(out_dir / "structural" / "gradcam_age*.png"))
               ) == 2
    heat = nifti.load(str(out_dir / "structural" / "gradcam_heatmapS000.nii")
                      ).get_fdata(np.float32)
    vol = driver_smri.load_smri(rows[0]["Path_sMRI_brain"], (2, 24))
    assert heat.shape == vol.shape == (24, 30, 22)
    assert heat.min() >= 0 and heat.max() <= 1 + 1e-6
