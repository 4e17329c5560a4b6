"""``TRAINING_REMAT``: the port's recompute of blocks 0..depth-2 against no
remat (bit for bit on the CPU plain path) and against the JAX Trainer's
remat step, at a tiny 3D ViT (grid 20, patch 5, dim 64, 4 heads of 16, MLP
128).

Tolerance against JAX: f32 within 1e-5 abs + 1e-4 rel of the loss and of
every updated parameter, the North star's (tests/test_torch_train.py).
"""

import jax
import numpy as np
import pytest
import torch

from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.parallel import create_mesh, shard_batch
from neurovit_tpu.training import Trainer as JaxTrainer
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.models.vit3d import Attention, FeedForward
from neurovit_tpu_torch.training import Trainer
from neurovit_tpu_torch.training.state_dict import from_jax_params

torch.set_num_threads(1)

BATCH, CLASSES = 8, 8


class _Volumes:
    def __len__(self):
        return 2 * BATCH

    def sample(self, idx):
        rng = np.random.RandomState(idx)
        return {"volume": rng.randn(20, 20, 20).astype(np.float32),
                "label": idx % CLASSES, "subject": f"s{idx}", "timepoint": 0}


def _batch(seed=7, n_valid=BATCH):
    rng = np.random.RandomState(seed)
    return {"volume": rng.randn(BATCH, 20, 20, 20).astype(np.float32),
            "label": rng.randint(0, CLASSES, BATCH).astype(np.int32),
            "valid": np.arange(BATCH) < n_valid}


def _torch_batch(b):
    return {"volume": torch.from_numpy(b["volume"]),
            "label": torch.from_numpy(b["label"]).long(),
            "valid": torch.from_numpy(b["valid"])}


def _config(tiny, **extra):
    return {**tiny, "KERNEL_IMPL": "pallas", "TRAINING_LEARNING_RATE": 1e-3,
            "TRAINING_BATCH_SIZE": BATCH, **extra}


def _logits_and_grads(config, remat, volume, seed):
    model = NeuroEncoder(dict(config, TRAINING_REMAT=remat), device="cpu")
    logits = model(volume, train=True, seed=seed)
    logits.logsumexp(-1).sum().backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_is_bit_equal_to_no_remat(tiny_config, dropout, precision,
                                        depth):
    """Logits and every parameter gradient, with and without remat."""
    config = _config(tiny_config, TRAINING_DROPOUT=dropout,
                     TRAINING_PRECISION=precision, MODEL_VIT_DEPTH=depth)
    volume = torch.from_numpy(_batch()["volume"])
    want_logits, want = _logits_and_grads(config, False, volume, seed=99)
    got_logits, got = _logits_and_grads(config, True, volume, seed=99)
    assert torch.equal(got_logits, want_logits)
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_trainer_step_with_remat_is_bit_equal(tiny_config, dropout):
    """One Trainer step (loss, metrics, every updated parameter) with
    TRAINING_REMAT against one without, on the same weights and seed."""
    config = _config(tiny_config, TRAINING_DROPOUT=dropout)
    batch = _torch_batch(_batch(n_valid=BATCH - 1))
    out = []
    for remat in (False, True):
        cfg = dict(config, TRAINING_REMAT=remat)
        trainer = Trainer(cfg, NeuroEncoder(cfg, device="cpu"), _Volumes(),
                          _Volumes())
        m = trainer.train_step(batch)
        out.append((m, trainer.model.state_dict()))
    (m0, sd0), (m1, sd1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert int(m0["correct"]) == int(m1["correct"])
    for key in sd0:
        assert torch.equal(sd0[key], sd1[key]), key


def test_remat_step_matches_jax_remat_step(tiny_config):
    """One port Trainer step with TRAINING_REMAT against one JAX Trainer
    step with remat (its Pallas kernels in interpret mode), on the same
    weights and batch: the loss and every updated parameter, f32."""
    config = _config(tiny_config, TRAINING_REMAT=True,
                     TRAINING_PRECISION="f32", MODEL_VIT_DEPTH=3)
    jmodel = JaxNeuroEncoder(config)
    assert jmodel.vit_cfg.remat
    mesh = create_mesh(config, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(config, jmodel, _Volumes(), _Volumes(), mesh=mesh)
    params = jax.tree.map(np.asarray, jtrainer.train_state["params"])
    model = NeuroEncoder(config, device="cpu")
    assert model.vit_cfg.remat
    model.load_state_dict(from_jax_params(params), strict=True)
    trainer = Trainer(config, model, _Volumes(), _Volumes())
    b = _batch(n_valid=BATCH - 2)
    jtrainer.train_state, jm = jtrainer._train_step(
        jtrainer.train_state, shard_batch(jtrainer._device_batch(b)[0], mesh))
    m = trainer.train_step(_torch_batch(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-5)
    assert int(m["correct"]) == int(jm["correct"])
    assert int(m["count"]) == int(jm["count"]) == BATCH - 2
    want = from_jax_params(jax.tree.map(np.asarray,
                                        jtrainer.train_state["params"]))
    got = trainer.model.state_dict()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_remat_recomputes_every_block_but_the_last(tiny_config, depth):
    """Forward calls of each block's attention and MLP in one train step:
    twice (the forward and the recompute in the backward) for blocks
    0..depth-2 with remat, once for the last block and without remat; an
    eval forward and a forward without grad recompute nothing. Counted on
    entry: the recompute stops as soon as the last saved tensor is
    recomputed (checkpoint's early stop), inside the MLP's forward, after
    its kernel has run."""
    for remat in (False, True):
        config = _config(tiny_config, TRAINING_REMAT=remat,
                         MODEL_VIT_DEPTH=depth, TRAINING_DROPOUT=0.1)
        model = NeuroEncoder(config, device="cpu")
        calls = {}
        for name, module in model.named_modules():
            if isinstance(module, (Attention, FeedForward)):
                calls[name] = 0
                module.register_forward_pre_hook(
                    lambda *_, name=name: calls.__setitem__(name,
                                                            calls[name] + 1))
        volume = torch.from_numpy(_batch()["volume"][:2])
        model(volume, train=True, seed=5).sum().backward()
        blocks = [calls[k] for k in sorted(calls)]
        want = []
        for i in range(depth):
            n = 2 if remat and i < depth - 1 else 1
            want += [n, n]
        assert blocks == want, (remat, calls)
        for name in calls:
            calls[name] = 0
        model(volume).sum().backward()
        with torch.no_grad():
            model(volume, train=True, seed=5)
        assert set(calls.values()) == {2}, calls


def test_remat_accepted_by_4d_and_resnet(tiny_config):
    """A 4D model (its frozen encoder records no graph) and a ResNet take
    TRAINING_REMAT and give the logits they give without it."""
    rng = np.random.RandomState(3)
    seq = torch.from_numpy(rng.randn(2, 20, 20, 20, 3).astype(np.float32))
    vol = torch.from_numpy(rng.randn(2, 20, 20, 20).astype(np.float32))
    for extra, x in (({"TRAINING_DIM": 4}, seq),
                     ({"MODEL_VOLUME_ENCODER": "resnet",
                       "MODEL_RESNET_DEPTH": 10}, vol)):
        out = []
        for remat in (False, True):
            config = _config(tiny_config, TRAINING_REMAT=remat, **extra)
            model = NeuroEncoder(config, device="cpu")
            logits = model(x, train=True, seed=1)
            logits.sum().backward()
            out.append(logits.detach())
        assert torch.equal(out[0], out[1]), extra
