"""The port's 4D Trainer against the JAX Trainer, and its feature cache and
int8 encoder, at the tiny ViT (grid 20, patch 5, dim 64, depth 2, 4 heads
of 16, MLP 128), batches of 2 sequences of T 3.

Tolerances: train steps at f32 within 1e-5 + 1e-4 rel (loss and every
updated parameter), at bf16 the losses within 5e-2 of their magnitude and
the gradients within 5e-2 relative Frobenius error;
cached against recomputed training within 1e-5 rel of each loss (the
JAX test's bound, tests/test_feature_cache_4d.py); the int8 encoder's
features within 0.05 relative error of JAX's q8 encoder
(tests/test_int8_serving.py's bound).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.parallel import create_mesh, shard_batch
from neurovit_tpu.training import Trainer as JaxTrainer
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.training import Trainer
from neurovit_tpu_torch.training import checkpoint as ckpt
from neurovit_tpu_torch.training import feature_cache
from neurovit_tpu_torch.training.state_dict import from_jax_params

torch.set_num_threads(1)

T = 3


class _Sequences:
    """[20, 20, 20, T] series made from the seed and the index, a bright
    cube whose place gives the label."""

    def __init__(self, n, seed=0, fail_idx=None):
        self.n, self.seed, self.fail_idx = n, seed, fail_idx

    def __len__(self):
        return self.n

    def sample(self, idx):
        if idx == self.fail_idx:
            return None
        rng = np.random.RandomState(self.seed * 1000 + idx)
        vol = 0.5 * rng.randn(20, 20, 20, T).astype(np.float32)
        lo = 2 if idx % 2 == 0 else 10
        vol[lo:lo + 8, lo:lo + 8, lo:lo + 8, :] += 3.0
        return {"volume": vol, "label": idx % 2, "subject": f"s{idx}",
                "timepoint": 0}


def _cfg(tiny, tmp_path, **kw):
    config = dict(tiny)
    config.update({"TRAINING_DIM": 4, "DATASET_NAME": "adni",
                   "TRAINING_BATCH_SIZE": 2, "TRAINING_EPOCHS": 2,
                   "TRAINING_LEARNING_RATE": 1e-3,
                   "TRAINING_DROPOUT": 0.0, "MODEL_TEMPORAL_DROPOUT": 0.0,
                   "TRAINING_NUM_WORKERS": 2,
                   "GLOBAL_OUTPUT_DIR": str(tmp_path / "runs"), **kw})
    return config


def _batches(n, seed=7):
    rng = np.random.RandomState(seed)
    return [{"volume": rng.randn(2, 20, 20, 20, T).astype(np.float32),
             "label": rng.randint(0, 2, 2).astype(np.int32),
             "valid": np.array([True, i == 0])}
            for i in range(n)]


def _torch_batch(b):
    return {"volume": torch.from_numpy(b["volume"]),
            "label": torch.from_numpy(b["label"]).long(),
            "valid": torch.from_numpy(b["valid"])}


def _both(config):
    """A JAX Trainer on one device and a port Trainer with its weights."""
    jmodel = JaxNeuroEncoder(config)
    mesh = create_mesh(config, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(config, jmodel, _Sequences(4), _Sequences(2, 1),
                          mesh=mesh)
    params = jax.tree.map(np.asarray, jtrainer.train_state["params"])
    model = NeuroEncoder(config, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return jtrainer, mesh, Trainer(config, model, _Sequences(4),
                                   _Sequences(2, 1))


def _close(got, want, precision):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if precision == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=5e-2 * max(float(np.abs(want).max()),
                                               1e-6))


# The temporal LayerNorms normalize d_model features. At d_model 2 (the
# reference's 4D head) LN's output is +-1 times its affine whatever its
# input, so every parameter before the last LayerNorm gets a gradient that
# is zero but for rounding (1e-13 to 1e-6 here, against 0.2 at the
# projection) in either package, and Adam turns that noise into steps of
# up to the learning rate. Those parameters are held to JAX at d_model 8.
# At any width the key bias's gradient is zero but for rounding too (it
# adds q . b_k to a whole row of scores, which the softmax ignores).
LIVE_AT_2 = ("temporal_transformer.transformer.layers.0.norm2.",
             "projection_head.")
IN_BIAS = "temporal_transformer.transformer.layers.0.self_attn.in_proj_bias"


def _live(key, v, d_model):
    """The entries of parameter ``key`` whose gradient is not zero but for
    rounding: the query and value biases of ``in_proj_bias``."""
    if key == IN_BIAS:
        return torch.cat([v[:d_model], v[2 * d_model:]])
    return v


def _jax_grads(jtrainer, b):
    """JAX's gradient of one micro-batch's masked mean CE, as port keys."""
    from neurovit_tpu.training.trainer import _masked_mean_ce

    def loss(params):
        logits, _ = jtrainer.model.apply(params, jnp.asarray(b["volume"]))
        return _masked_mean_ce(logits, jnp.asarray(b["label"]),
                               jnp.asarray(b["valid"]))[0]

    return from_jax_params(jax.tree.map(np.asarray, jax.grad(loss)(
        jtrainer.train_state["params"])))


def _port_grads(trainer, b):
    from neurovit_tpu_torch import nn
    tb = _torch_batch(b)
    nn.masked_mean_ce(trainer.model(tb["volume"]), tb["label"],
                      tb["valid"])[0].backward()
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    trainer.optimizer.opt.zero_grad(set_to_none=True)
    return grads


@pytest.mark.parametrize("d_model", [2, 8])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_two_steps_with_accumulation_match_jax(tiny_config, tmp_path,
                                               precision, d_model):
    """TRAINING_ACCUMULATION_STEP 2 over two micro-batches (the second with
    a padding row): each loss against the JAX Trainer, the frozen encoder
    bit-unchanged, one optimizer step. f32: every updated temporal and
    projection parameter against JAX's. bf16: the first micro-batch's
    gradients within 5e-2 relative Frobenius error per tensor (Adam's first
    step is about lr times the sign of each gradient, so a bf16 gradient
    near zero may step either way in either package; JAX's backward of a
    bf16 dot rounds at other points than autograd's of the port's f32 sums,
    and a ReLU input at a rounding boundary moves single elements)."""
    config = _cfg(tiny_config, tmp_path, TRAINING_ACCUMULATION_STEP=2,
                  TRAINING_PRECISION=precision,
                  DATASET_NAME="adni" if d_model == 2 else "gradcam")
    jtrainer, mesh, trainer = _both(config)
    assert trainer.model.num_classes == d_model
    batches = _batches(2)
    if precision == "bf16":
        want = _jax_grads(jtrainer, batches[0])
        for key, g in _port_grads(trainer, batches[0]).items():
            if d_model == 8 or key.startswith(LIVE_AT_2):
                g, w = _live(key, g, d_model), _live(key, want[key], d_model)
                err = float((g - w).norm() / w.norm())
                assert err < 5e-2, (key, err)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for b in batches:
        jb = shard_batch(jtrainer._device_batch(b)[0], mesh, replicate=True)
        jtrainer.train_state, jm = jtrainer._train_step(jtrainer.train_state,
                                                        jb)
        m = trainer.train_step(_torch_batch(b))
        _close(float(m["loss"]), float(jm["loss"]), precision)
        assert int(m["count"]) == int(jm["count"])
    want = from_jax_params(jax.tree.map(np.asarray,
                                        jtrainer.train_state["params"]))
    moved = 0
    for key, v in trainer.model.state_dict().items():
        if key.startswith("volume_encoder."):
            assert torch.equal(v, before[key]), key
            continue
        moved += int(not torch.equal(v, before[key]))
        if precision == "f32" and (d_model == 8 or key.startswith(LIVE_AT_2)):
            _close(_live(key, v, d_model).numpy(),
                   _live(key, want[key], d_model).numpy(), precision)
    assert moved > 0
    assert trainer.optimizer.steps == 1


def test_d_model_2_trains_only_the_last_norm_and_projection(tiny_config,
                                                            tmp_path):
    """At d_model 2 the gradients of every temporal parameter before the
    last LayerNorm are rounding noise, in JAX and in the port alike: below
    1e-4 of the projection's gradient."""
    config = _cfg(tiny_config, tmp_path)
    jtrainer, _, trainer = _both(config)
    b = _batches(1)[0]
    for g in (_jax_grads(jtrainer, b), _port_grads(trainer, b)):
        live = float(g["projection_head.projection_head.weight"].abs().max())
        assert live > 1e-2
        for key, v in g.items():
            if key.startswith("temporal_transformer.") and \
                    not key.startswith(LIVE_AT_2):
                assert float(v.abs().max()) < 1e-4 * live, key


def _run(config, epochs=2, train=None, val=None):
    """A port Trainer's epochs; returns it and its train-step losses."""
    trainer = Trainer(config, NeuroEncoder(config, device="cpu"),
                      train or _Sequences(6), val or _Sequences(2, 1))
    losses = []
    step = trainer.train_step

    def recorded(*args, **kwargs):
        m = step(*args, **kwargs)
        losses.append(float(m["loss"]))
        return m

    trainer.train_step = recorded
    for epoch in range(epochs):
        trainer.train(epoch)
        trainer.validate(epoch)
    return trainer, losses


def test_cache_matches_recompute(tiny_config, tmp_path):
    """Cached features against the volume path, dropout 0.1 on: the same
    shuffles, the same per-step seeds, the same tail, so the same losses;
    the cache holds [T, C] f32 arrays and is built once."""
    config = _cfg(tiny_config, tmp_path, MODEL_TEMPORAL_DROPOUT=0.1)
    base, losses = _run(config)
    cached, cached_losses = _run(dict(config,
                                      TRAINING_4D_FEATURE_CACHE=True))
    assert base._feature_cache is None
    view = cached._feature_cache["train"]
    assert len(view) == 6 and all(f.shape == (T, 2) and f.dtype == np.float32
                                  for f in view.feats)
    np.testing.assert_allclose(cached_losses, losses, rtol=1e-5)
    np.testing.assert_allclose(cached.val_loss, base.val_loss, rtol=1e-5)
    x = torch.from_numpy(_Sequences(6).sample(3)["volume"][None])
    np.testing.assert_allclose(view.feats[3], cached.model.encode_sequence(
        x)[0].numpy(), rtol=1e-6, atol=1e-6)


def test_cache_masks_failed_reads(tiny_config, tmp_path):
    config = _cfg(tiny_config, tmp_path, TRAINING_4D_FEATURE_CACHE=True)
    trainer, _ = _run(config, epochs=1, train=_Sequences(6, fail_idx=3))
    assert trainer._feature_cache["train"].feats[3] is None
    assert np.isfinite(trainer.val_loss)


def test_persisted_view_reloads_by_fingerprint(tiny_config, tmp_path,
                                               monkeypatch):
    """TRAINING_4D_FEATURE_CACHE_DIR: a second Trainer reloads both views
    without encoding; other encoder weights change the fingerprint, and the
    stale file is refused and encoded again."""
    config = _cfg(tiny_config, tmp_path, TRAINING_4D_FEATURE_CACHE=True,
                  TRAINING_4D_FEATURE_CACHE_DIR=str(tmp_path / "cache"))
    first, _ = _run(config, epochs=1)
    path = os.path.join(config["TRAINING_4D_FEATURE_CACHE_DIR"],
                        "feats_train.npz")
    assert os.path.exists(path)
    calls = []
    real = feature_cache.precompute
    monkeypatch.setattr(feature_cache, "precompute",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    second, _ = _run(config, epochs=1)
    assert not calls
    for a, b in zip(first._feature_cache["train"].feats,
                    second._feature_cache["train"].feats):
        np.testing.assert_array_equal(a, b)

    other = Trainer(config, NeuroEncoder(config, device="cpu", seed=9),
                    _Sequences(6), _Sequences(2, 1))
    fp = feature_cache.fingerprint(other.model.frozen_encoder, False,
                                   _Sequences(6))
    assert fp != feature_cache.fingerprint(second.model.frozen_encoder,
                                           False, _Sequences(6))
    assert feature_cache.load_view(path, fp) is None
    assert fp != feature_cache.fingerprint(other.model.frozen_encoder,
                                           True, _Sequences(6))
    other.train(0)
    assert len(calls) == 2                     # train and val encoded again
    with open(path, "wb") as f:
        f.write(b"torn")
    assert feature_cache.load_view(path, fp) is None


def test_int8_encoder_matches_jax_q8(tiny_config, tmp_path):
    """TRAINING_4D_ENCODER_QUANT: int8: the port's int8 copy of the encoder
    against JAX's q8 model state, within the int8 bound; the copy is
    outside the model's state dict and parameters, the model keeps its f32
    weights, and a checkpoint has a bf16 run's keys and encoder weights."""
    config = _cfg(tiny_config, tmp_path, TRAINING_PRECISION="bf16",
                  TRAINING_4D_ENCODER_QUANT="int8")
    jtrainer, mesh, trainer = _both(config)
    x = _batches(1)[0]["volume"]
    ts = jtrainer.train_state
    want, _, _ = jtrainer.model.encode_sequence(ts["params"],
                                                ts["model_state"],
                                                jnp.asarray(x))
    got = trainer.model.encode_sequence(torch.from_numpy(x),
                                        encoder=trainer._q8_encoder)
    want = np.asarray(want, np.float32)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 0.05
    bf16 = trainer.model.encode_sequence(torch.from_numpy(x))
    assert not torch.equal(got, bf16)
    assert trainer._q8_encoder.quantized
    names = set(trainer.model.state_dict())
    assert not any(k.endswith("_w8") for k in names)
    q8_params = {id(p) for p in trainer._q8_encoder.parameters()}
    assert not q8_params & {id(p) for p in trainer.model.parameters()}

    encoder = {k: v.clone() for k, v in trainer.model.state_dict().items()
               if k.startswith("volume_encoder.")}
    trainer.train_step(_torch_batch(_batches(1)[0]))
    path = str(tmp_path / "q8" / "model-e0")
    ckpt.save_train_state(path, trainer._checkpoint_state(), trainer.model)
    plain = NeuroEncoder(dict(config, TRAINING_4D_ENCODER_QUANT="none"),
                         device="cpu")
    weights = ckpt.sd.load(path + ".state_dict.pkl")
    assert set(weights) == set(plain.state_dict())
    for key, v in encoder.items():
        assert weights[key].dtype == torch.float32
        assert torch.equal(weights[key], v), key

    # restore() quantizes the restored weights again.
    other = Trainer(config, NeuroEncoder(config, device="cpu", seed=3),
                    _Sequences(4), _Sequences(2, 1))
    other.restore(path)
    again = other.model.encode_sequence(torch.from_numpy(x),
                                        encoder=other._q8_encoder)
    assert torch.equal(again, got)


def test_int8_encoder_matches_jax_q8_at_f32(tiny_config, tmp_path):
    """TRAINING_4D_ENCODER_QUANT: int8 at TRAINING_PRECISION f32: the port's
    int8 copy of the f32 encoder against JAX's q8 model state, whose
    kernels take and give f32 activations there, within 1e-3 relative
    error (both sides take the same int32 products; an f32 LayerNorm or
    score sum in another order can move a code by one step); the copy is
    the bf16 run's, with f32 activations throughout."""
    config = _cfg(tiny_config, tmp_path, TRAINING_PRECISION="f32",
                  TRAINING_4D_ENCODER_QUANT="int8")
    jtrainer, _, trainer = _both(config)
    x = _batches(1)[0]["volume"]
    ts = jtrainer.train_state
    want, _, _ = jtrainer.model.encode_sequence(ts["params"],
                                                ts["model_state"],
                                                jnp.asarray(x))
    got = trainer.model.encode_sequence(torch.from_numpy(x),
                                        encoder=trainer._q8_encoder)
    assert got.dtype == torch.float32 and trainer._q8_encoder.quantized
    want = np.asarray(want, np.float32)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-3
    assert not torch.equal(got, trainer.model.encode_sequence(
        torch.from_numpy(x)))


def test_quant_rejects_resnet_and_unknown_modes(tiny_config, tmp_path):
    config = _cfg(tiny_config, tmp_path, TRAINING_4D_ENCODER_QUANT="int8",
                  MODEL_VOLUME_ENCODER="resnet", MODEL_RESNET_DEPTH=10)
    with pytest.raises(ValueError, match="ViT"):
        Trainer(config, NeuroEncoder(config, device="cpu"), _Sequences(4),
                _Sequences(2, 1))
    config = _cfg(tiny_config, tmp_path, TRAINING_4D_ENCODER_QUANT="int4")
    with pytest.raises(ValueError, match="int8"):
        Trainer(config, NeuroEncoder(config, device="cpu"), _Sequences(4),
                _Sequences(2, 1))
    # Inert in 3D, as in JAX: no int8 copy.
    config3d = dict(config, TRAINING_DIM=3, TRAINING_4D_ENCODER_QUANT="int8")
    trainer = Trainer(config3d, NeuroEncoder(config3d, device="cpu"),
                      _Sequences(4), _Sequences(2, 1))
    assert trainer._q8_encoder is None


def test_run_checkpoints_resume_the_4d_head(tiny_config, tmp_path,
                                            monkeypatch):
    """Trainer.run() writes the 4D model's checkpoint (temporal head and
    frozen encoder) and last_model; --resume continues with the identical
    next step, the feature cache built again from the restored weights."""
    monkeypatch.chdir(tmp_path)
    config = _cfg(tiny_config, tmp_path, TRAINING_EPOCHS=1,
                  MODEL_TEMPORAL_DROPOUT=0.1, TRAINING_4D_FEATURE_CACHE=True)
    trainer = Trainer(config, NeuroEncoder(config, device="cpu"),
                      _Sequences(4), _Sequences(2, 1))
    trainer.run()
    path, = glob.glob(os.path.join(config["GLOBAL_OUTPUT_DIR"], "*",
                                   "model-e0"))
    weights = ckpt.sd.load(path + ".state_dict.pkl")
    last = ckpt.sd.load(os.path.join("results", "last_model.pkl"))
    for key, v in trainer.model.state_dict().items():
        assert torch.equal(weights[key], v) and torch.equal(last[key], v)
    b = _torch_batch(_batches(1, seed=3)[0])
    want = float(trainer.train_step(b)["loss"])
    other = Trainer(config, NeuroEncoder(config, device="cpu", seed=4),
                    _Sequences(4), _Sequences(2, 1))
    other.restore(path)
    assert other.epoch == 1 and other._feature_cache is None
    assert float(other.train_step(b)["loss"]) == want


def test_host_bf16_casts_whole_sequences(tiny_config, tmp_path):
    """TRAINING_HOST_TRANSFER_DTYPE: bf16 ships each batch of series as
    bf16 (the model's first cast, done on the host): the same losses as
    the f32 transfer under bf16 compute, and the precompute pass too."""
    config = _cfg(tiny_config, tmp_path, TRAINING_PRECISION="bf16",
                  MODEL_TEMPORAL_DROPOUT=0.1)
    _, want = _run(config, epochs=1)
    trainer, got = _run(dict(config, TRAINING_HOST_TRANSFER_DTYPE="bf16"),
                        epochs=1)
    assert got == want
    host, _ = trainer._host_batch(next(iter(trainer.dataloader)))
    assert host["volume"].dtype == torch.bfloat16
    assert host["volume"].shape == (2, 20, 20, 20, T)
    _, got = _run(dict(config, TRAINING_HOST_TRANSFER_DTYPE="bf16",
                       TRAINING_4D_FEATURE_CACHE=True), epochs=1)
    assert got == want
