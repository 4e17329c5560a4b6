"""The exact-regime run: the port's Trainer against the JAX Trainer for
three epochs of the synthetic cube task, as tests/test_train_parity.py sets
it up (tiny ViT, dropout 0, f32, AdamW lr 1e-3 / wd 0.01, batch 8,
identical initial weights and batch stream, each epoch's order shuffled
from seed 11 + epoch).

Per-epoch mean train losses agree to rtol 1e-3 and the validation
accuracies are identical every epoch. The tier-1 case takes the first 6
steps of each epoch; the full run (every batch of the 200-sample set) is
marked slow, as the JAX package's own full-run parity test is.
"""

import jax
import numpy as np
import pytest
import torch

from neurovit_tpu.data.synthetic import GradCAMDataset
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.parallel import create_mesh, shard_batch
from neurovit_tpu.training import Trainer as JaxTrainer
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.training import Trainer
from neurovit_tpu_torch.training.state_dict import from_jax_params

torch.set_num_threads(1)

EPOCHS, BATCH, SEED = 3, 8, 11


def _cube_task(tiny_config):
    config = {**tiny_config, "GRADCAM_NUM_SAMPLES": 200,
              "GRADCAM_TRAIN_PATH": None, "GRADCAM_VAL_PATH": None,
              "TRAINING_LEARNING_RATE": 1e-3, "TRAINING_WEIGHT_DECAY": 0.01,
              "TRAINING_ACCUMULATION_STEP": 1,
              "TRAINING_LR_SCHEDULE": "constant",
              "TRAINING_BATCH_SIZE": BATCH, "TRAINING_DROPOUT": 0.0,
              "TRAINING_PRECISION": "f32", "KERNEL_IMPL": "xla"}
    train_ds, val_ds = (GradCAMDataset(config, mode)
                        for mode in ("train", "val"))
    train = [train_ds.sample(i) for i in range(len(train_ds))]
    val = [val_ds.sample(i) for i in range(len(val_ds))]
    epochs = []
    for e in range(EPOCHS):
        order = np.arange(len(train))
        np.random.RandomState(SEED + e).shuffle(order)
        epochs.append([{
            "volume": np.stack([train[i]["volume"] for i in idxs]),
            "label": np.array([train[i]["label"] for i in idxs], np.int32),
            "valid": np.ones(BATCH, np.bool_)}
            for idxs in (order[b0:b0 + BATCH] for b0 in
                         range(0, len(train) - BATCH + 1, BATCH))])
    val_batch = {"volume": np.stack([s["volume"] for s in val]),
                 "label": np.array([s["label"] for s in val], np.int32),
                 "valid": np.ones(len(val), np.bool_)}
    return config, epochs, val_batch, train_ds


def _torch_batch(b):
    return {"volume": torch.from_numpy(b["volume"]),
            "label": torch.from_numpy(b["label"]).long(),
            "valid": torch.from_numpy(b["valid"])}


@pytest.mark.parametrize("steps", [6, pytest.param(None,
                                                    marks=pytest.mark.slow)])
def test_three_epochs_match_jax_exact_regime(tiny_config, steps):
    config, epochs, val_batch, train_ds = _cube_task(tiny_config)
    jmodel = JaxNeuroEncoder(config)
    mesh = create_mesh(config, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(config, jmodel, train_ds, train_ds, mesh=mesh)
    params = jax.tree.map(np.asarray, jtrainer.train_state["params"])
    model = NeuroEncoder(config, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    trainer = Trainer(config, model, train_ds, train_ds)

    jval = shard_batch(val_batch, mesh)
    val = _torch_batch(val_batch)
    losses, jlosses, accs, jaccs = [], [], [], []
    for batches in epochs:
        ep, jep = [], []
        for b in batches[:steps]:
            jtrainer.train_state, jm = jtrainer._train_step(
                jtrainer.train_state, shard_batch(
                    jtrainer._device_batch(b)[0], mesh))
            jep.append(float(jm["loss"]))
            ep.append(float(trainer.train_step(_torch_batch(b))["loss"]))
        jlosses.append(float(np.mean(jep)))
        losses.append(float(np.mean(ep)))
        jm = jtrainer._eval_step(jtrainer.train_state["params"],
                                 jtrainer.train_state["model_state"], jval)
        m = trainer.eval_step(val)
        jaccs.append(float(jm["correct"]) / float(jm["count"]))
        accs.append(float(m["correct"]) / float(m["count"]))
        np.testing.assert_array_equal(m["preds"].numpy(),
                                      np.asarray(jm["preds"]))
    print(f"port losses {losses} accs {accs}")
    print(f"jax  losses {jlosses} accs {jaccs}")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert accs == jaccs
    assert len(val_batch["label"]) == 40 and len(epochs[0]) == 20
    if steps is None:
        assert accs[-1] >= 0.9, accs
