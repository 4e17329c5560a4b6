"""The port's data-parallel train steps at 2 and 4 gloo ranks on the CPU,
against the port's one-process steps and the JAX Trainer on a
data-parallel mesh of as many virtual devices; and its tensor-parallel
steps on one group of 4 ranks (dp 2 x tp 2), against the same and the
JAX Trainer on a dp 2 x tp 2 mesh.

Each world size spawns one group (``torch.multiprocessing``, a
``file://`` rendezvous) whose ranks run every case of
``tests/torch_parallel_worker.py``; the one-process results come from the
same cases run here without a group. The tiny config of
``tests/conftest.py`` (20^3, patch 5, dim 64, depth 2, f32, dropout 0).

Tolerances, the JAX test's own (``tests/test_sharding.py:57-89``): each
loss within 1e-5 relative, each updated parameter within 2e-4 relative +
1e-5 absolute; the reduced gradients within 1e-4 relative Frobenius error
per tensor, a tensor's norm floored at 1e-3 of the largest gradient norm
of the model; in 4D each tensor's error is held to 1e-4 of the model's
largest gradient norm (the temporal layer's attention and MLP gradients
are 1e-10 to 1e-4 of the head's and move with the last bits of the
encodings, which a split B·T stream computes in other batches, and with
the int8 encoder's codes). Against the JAX data-parallel step, the port's Trainer-against-
JAX bound (``tests/test_torch_train.py``): 1e-5 absolute + 1e-4 relative.
The parameters are bit-equal across the ranks. After AdamW's first step
an element whose gradient is below 1e-5 of its tensor's largest has moved
by up to lr on the sign of f32 rounding noise (lr * g / (|g| + 1e-8)), so
such elements may differ by up to 2 lr (the rule of
``tests/test_torch_resnet.py``); every other element holds the bound.
"""

import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_worker as worker
from neurovit_tpu.config import load_config as jax_load_config
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.parallel import create_mesh as jax_create_mesh
from neurovit_tpu.parallel import shard_batch
from neurovit_tpu.training import Trainer as JaxTrainer
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.parallel import sharding
from neurovit_tpu_torch.training.state_dict import from_jax_params

torch.set_num_threads(1)

WORLDS = (2, 4)
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5
GRAD_RTOL = 1e-4
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5


def _jax_trainer(workdir, world):
    config = jax_load_config(overrides=worker.overrides(str(workdir)))
    mesh = jax_create_mesh(config, devices=jax.devices()[:world])
    return JaxTrainer(config, JaxNeuroEncoder(config), worker.Volumes(64),
                      worker.Volumes(64), mesh=mesh), mesh


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The JAX trainer's initial weights where both the ranks and the
    one-process run read them."""
    root = tmp_path_factory.mktemp("parallel")
    jtrainer, _ = _jax_trainer(root, 1)
    weights = from_jax_params(jax.tree.map(
        np.asarray, jtrainer.train_state["params"]))
    for sub in ["single", "tp/ranks"] + [f"w{w}/ranks" for w in WORLDS]:
        os.makedirs(root / sub, exist_ok=True)
        torch.save(weights, root / sub / "vit_weights.pt")
    return root


@pytest.fixture(scope="module")
def single(workdir):
    return worker.run_cases(str(workdir / "single"))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, workdir):
    world = request.param
    root = workdir / f"w{world}"
    mp.spawn(worker.rank_main, args=(world, str(root)), nprocs=world)
    return [torch.load(root / f"rank{r}.pt") for r in range(world)]


def _hold_losses(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=LOSS_RTOL)
        assert g[1:] == w[1:]                     # correct, count


LR = 1e-3          # the worker's TRAINING_LEARNING_RATE


def _hold_state(got, want, grads=None, lr=LR):
    for key, w in want.items():
        g = got[key]
        if not w.is_floating_point():
            assert torch.equal(g, w), key
            continue
        diff = (g - w).abs()
        bad = diff > PARAM_ATOL + PARAM_RTOL * w.abs()
        if grads is not None and key in grads and bad.any():
            noise = grads[key].abs() <= 1e-5 * grads[key].abs().max()
            assert (noise[bad]).all(), key
            assert (diff[bad] <= 2 * lr).all(), key
        else:
            assert not bad.any(), (key, float(diff.max()))


def _hold_grads(got, want, floor=1e-3):
    for g_window, w_window in zip(got, want):
        assert g_window.keys() == w_window.keys()
        least = floor * max(float(w.norm()) for w in w_window.values())
        for key, w in w_window.items():
            err = float((g_window[key] - w).norm()) / max(float(w.norm()),
                                                          least)
            assert err <= GRAD_RTOL, (key, err)


def _same_on_every_rank(ranks, case, key="state"):
    first = ranks[0][case][key]
    for other in ranks[1:]:
        for name, value in first.items():
            assert torch.equal(other[case][key][name], value), (case, name)


@pytest.mark.parametrize("case", ["vit", "accum", "fourd", "fourd_int8"])
def test_step_matches_one_process(ranks, single, case):
    """The 3D ViT at global batch 16, an accumulation window of 2 (the
    second micro-batch with 13 valid rows), and the 4D model with its
    B·T stream split over the ranks (bf16-free f32, the plain encoder and
    the int8 one): losses, reduced gradients, updated parameters; the
    parameters bit-equal on every rank."""
    for res in ranks:
        _hold_losses(res[case]["metrics"], single[case]["metrics"])
        _hold_grads(res[case]["grads"], single[case]["grads"],
                    floor=1.0 if case.startswith("fourd") else 1e-3)
        _hold_state(res[case]["state"], single[case]["state"],
                    grads=single[case]["grads"][-1])
    _same_on_every_rank(ranks, case)


@pytest.mark.parametrize("case", ["fourd", "fourd_int8"])
def test_fourd_stream_split_gathers_the_encodings(ranks, single, case):
    """Each rank encodes its 1/world of the B·T = 8 volumes and the
    gathered encodings are the one-process encodings (within the loss
    bound; the same rows through a smaller batch), equal on every rank."""
    want = single[case]["enc"]
    for res in ranks:
        assert torch.equal(res[case]["enc"], ranks[0][case]["enc"])
        np.testing.assert_allclose(res[case]["enc"].numpy(), want.numpy(),
                                   rtol=LOSS_RTOL, atol=1e-6)


def test_feature_cache_written_by_rank0(ranks, single):
    """The persisted 4D feature cache: rank 0 writes the two views once,
    every rank trains an epoch on the same features (the one-process
    features within the encodings' bound), parameters bit-equal on the
    ranks and within the bound of one process's."""
    want = single["feature_cache"]
    for res in ranks:
        assert res["feature_cache"]["files"] == ["feats_train.npz",
                                                 "feats_val.npz"]
        assert torch.equal(res["feature_cache"]["feats"],
                           ranks[0]["feature_cache"]["feats"])
        np.testing.assert_allclose(res["feature_cache"]["feats"].numpy(),
                                   want["feats"].numpy(), rtol=LOSS_RTOL,
                                   atol=1e-6)
        _hold_state(res["feature_cache"]["state"], want["state"])
    _same_on_every_rank(ranks, "feature_cache")


def test_ragged_last_batch_epoch(ranks, single):
    """An epoch over 27 volumes at global batch 16 through the sharded
    loaders: the last batch's 11 valid rows fall unevenly on the ranks
    (and the short shards wrap); each step's global loss and counts, the
    parameters after the epoch."""
    for res in ranks:
        _hold_losses(res["ragged"]["metrics"], single["ragged"]["metrics"])
        _hold_state(res["ragged"]["state"], single["ragged"]["state"])
    _same_on_every_rank(ranks, "ragged")


def test_validation_metrics(ranks, single):
    """Validation over 13 volumes at global batch 16 (all-reduced loss and
    counts) and evaluate_samples' accuracy (predictions gathered in the
    global order): the one-process numbers on every rank; rank 0 alone
    logs, the other ranks' loggers get nothing."""
    want = single["ragged"]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["ragged"]["val_loss"],
                                   want["val_loss"], rtol=LOSS_RTOL)
        assert res["ragged"]["accuracy"] == want["accuracy"]
    logged = ranks[0]["ragged"]["logged"]
    val = [r for r in logged if "val_loss" in r]
    assert len(val) == 1 and val[0]["val_accuracy"] == pytest.approx(
        [r for r in want["logged"] if "val_loss" in r][0]["val_accuracy"])


def test_resnet_global_batch_norm(ranks, single):
    """A ResNet-10 step at global batch 8, 5 rows valid, through the
    global BatchNorm statistics: the loss, the gradients and parameters
    (AdamW's noise-sign elements aside, see the module's docstring), the
    running statistics within the bound, all bit-equal on every rank."""
    want = single["resnet"]
    for res in ranks:
        _hold_losses(res["resnet"]["metrics"], want["metrics"])
        _hold_grads(res["resnet"]["grads"], want["grads"])
        _hold_state(res["resnet"]["state"], want["state"],
                    grads=want["grads"][0])
        stats = [k for k in want["state"] if "running_" in k]
        assert stats
        for key in stats:
            np.testing.assert_allclose(res["resnet"]["state"][key].numpy(),
                                       want["state"][key].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)
    _same_on_every_rank(ranks, "resnet")


def test_checkpoint_written_by_rank0_restores_on_every_rank(ranks, single):
    """Rank 0 writes the train state (one file and its weights); every
    rank restores it into a model of other weights, bit-equal to the
    trainer that wrote it, and the next step of each matches."""
    for res in ranks:
        out = res["restore"]
        assert out["files"] == ["state", "state.state_dict.pkl"]
        for key, value in single["restore"]["restored"].items():
            assert torch.equal(out["restored"][key],
                               ranks[0]["restore"]["restored"][key]), key
        for key, value in out["after"].items():
            assert torch.equal(value, out["want"][key]), key
        _hold_losses(out["metrics"], single["restore"]["metrics"])
        _hold_state(out["after"], single["restore"]["after"])


def test_ranks_draw_different_dropout_masks(ranks, single):
    """At dropout 0.1 rank 0 draws the one-process step seed, so its masks
    are the ones one process draws; every other rank draws another seed,
    and its masks differ."""
    seeds = [res["dropout"]["seeds"][0] for res in ranks]
    assert seeds[0] == single["dropout"]["seeds"][0]
    assert len(set(seeds)) == len(seeds)
    masks = [nn.keep_mask(nn.site_seed(s, 1), (16, 126, 64), 0.1)
             for s in seeds]
    for m in masks[1:]:
        assert not torch.equal(m, masks[0])


def test_step_matches_jax_data_parallel_mesh(ranks, single, workdir):
    """The same global batch through the JAX Trainer on a data-parallel
    mesh of ``world`` virtual devices (KERNEL_IMPL xla), from the same
    weights: the loss and every updated parameter (AdamW's noise-sign
    elements aside, by the port's one-process gradients)."""
    world = len(ranks)
    jtrainer, mesh = _jax_trainer(workdir / f"w{world}", world)
    batch = worker.global_batches(1)[0]
    batch = dict(batch, label=batch["label"].astype(np.int32))
    jb = shard_batch(jtrainer._device_batch(batch)[0], mesh)
    ts, jm = jtrainer._train_step(jtrainer.train_state, jb)
    want = from_jax_params(jax.tree.map(np.asarray, ts["params"]))
    for res in ranks:
        np.testing.assert_allclose(res["vit"]["metrics"][0][0],
                                   float(jm["loss"]), rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
        assert res["vit"]["metrics"][0][2] == int(jm["count"]) == 16
        grads = single["vit"]["grads"][0]
        for key, w in want.items():
            g = res["vit"]["state"][key]
            diff = (g - w).abs()
            bad = diff > JAX_ATOL + JAX_RTOL * w.abs()
            noise = grads[key].abs() <= 1e-5 * grads[key].abs().max()
            assert (noise[bad]).all() and (diff[bad] <= 2 * LR).all(), key


def test_preemption_stops_every_rank_at_one_boundary(ranks, single):
    """A preemption asked of the last rank after the second step stops
    every rank there, and rank 0 writes the one train state (and its
    weights); no epoch checkpoint is written."""
    want = single["preempt"]
    assert want["steps"] == 2
    for res in ranks:
        assert res["preempt"]["steps"] == 2
    saved = ranks[0]["preempt"]["saved"]
    assert [os.path.basename(f) for f in saved] == [
        "model-preempt", "model-preempt.state_dict.pkl"]
    assert [os.path.basename(f) for f in want["saved"]] == [
        os.path.basename(f) for f in saved]


def test_batch_size_the_world_does_not_divide_is_refused(ranks, single):
    """TRAINING_BATCH_SIZE is the global batch. 15 over 2 or 4 ranks was
    refused; JAX pads it to a multiple of the data axis instead
    (trainer.py:711-721), and so does the port now: no refusal, each rank
    takes ceil(15 / world) rows of the padded batch, and the step is one
    process's step on the 15 rows (the ViT has no batch statistics, so
    the invalid pad rows change nothing)."""
    assert single["batch_refusal"]["error"] is None
    for res in ranks:
        out = res["batch_refusal"]
        assert out["error"] is None
        assert out["rows"] == -(-15 // len(ranks))
        _hold_losses(out["metrics"], single["batch_refusal"]["metrics"])
        _hold_state(out["state"], single["batch_refusal"]["state"])
    _same_on_every_rank(ranks, "batch_refusal")


# ---------------------------------------------------------------------------
# Tensor parallelism: one group of 4 ranks, dp 2 x tp 2
# ---------------------------------------------------------------------------

TP_WORLD = 4


@pytest.fixture(scope="module")
def tp_ranks(workdir):
    """Every case of worker.TP_CASES on one dp 2 x tp 2 group of 4 gloo
    ranks, spawned once."""
    root = workdir / "tp"
    mp.spawn(worker.tp_rank_main, args=(TP_WORLD, str(root)),
             nprocs=TP_WORLD)
    return [torch.load(root / f"rank{r}.pt") for r in range(TP_WORLD)]


def _jax_tp_step(workdir, batch, **extra):
    """The JAX Trainer's step on a dp 2 x tp 2 mesh of four virtual
    devices (KERNEL_IMPL xla) from its init, which the ranks loaded:
    (loss, count, the updated parameters under the port's keys)."""
    config = jax_load_config(overrides=worker.overrides(
        str(workdir), MESH_MODEL_AXIS=2, **extra))
    mesh = jax_create_mesh(config, devices=jax.devices()[:TP_WORLD])
    jtrainer = JaxTrainer(config, JaxNeuroEncoder(config),
                          worker.Volumes(64), worker.Volumes(64), mesh=mesh)
    batch = dict(batch, label=batch["label"].astype(np.int32))
    jb = shard_batch(jtrainer._device_batch(batch)[0], mesh)
    ts, jm = jtrainer._train_step(jtrainer.train_state, jb)
    return (float(jm["loss"]), int(jm["count"]),
            from_jax_params(jax.tree.map(np.asarray, ts["params"])))


def _hold_jax(res, want, grads, rtol, atol):
    """The ranks' whole parameters after the step against JAX's, AdamW's
    noise-signed elements aside (the module's rule)."""
    for key, w in want.items():
        g = res["state"][key]
        diff = (g - w).abs()
        bad = diff > atol + rtol * w.abs()
        noise = grads[key].abs() <= 1e-5 * grads[key].abs().max()
        assert (noise[bad]).all() and (diff[bad] <= 2 * LR).all(), key


@pytest.mark.parametrize("case,batch", [("tp_vit", 16), ("tp_vit_pad", 5)])
def test_tp_step_matches_jax_dp_tp_step(tp_ranks, single, workdir, case,
                                        batch):
    """The f32 step on dp 2 x tp 2 against JAX's step on a dp 2 x tp 2 mesh
    from the same weights, at JAX's bounds (tests/test_sharding.py:83-89):
    the loss within 1e-5 relative, each updated parameter within 2e-4
    relative + 1e-5 absolute; at batch 5 the data axis pads the batch to
    6 in both. Every rank holds the same whole state and its own shard's
    shapes."""
    b = worker.global_batches(1, b=batch)[0]
    loss, count, want = _jax_tp_step(workdir / "tp", b,
                                     TRAINING_BATCH_SIZE=batch)
    grads = single["vit"]["grads"][0]
    for r, res in enumerate(tp_ranks):
        out = res[case]
        np.testing.assert_allclose(out["metrics"][0][0], loss, rtol=1e-5)
        assert out["metrics"][0][2] == count == batch
        _hold_jax(out, want, grads, rtol=2e-4, atol=1e-5)
        assert out["mesh"] == (r // 2, r % 2, 2, 2)
        qkv = "volume_encoder.vit3d.transformer.layers.0.0.to_qkv.weight"
        assert out["shard"][qkv] == (3 * 32, 64)
    _same_on_every_rank(tp_ranks, case)


def test_tp_bf16_step_matches_jax_dp_tp_step(tp_ranks, single, workdir):
    """The bf16 step on dp 2 x tp 2 against JAX's bf16 step on its dp 2 x
    tp 2 mesh: the port's bf16 Trainer-against-JAX bound
    (tests/test_torch_train.py: 5e-2 of each tensor's largest magnitude;
    bf16 gradients differ by an ulp now and then and Adam's first step
    amplifies the sign of small ones). An element whose gradient (one
    process's, f32) is within bf16's resolution of 0, 2^-6 of its tensor's
    largest, may take AdamW's first step either way: it may differ by up
    to 2 lr (the module's rule, at bf16's noise)."""
    b = worker.global_batches(1)[0]
    loss, count, want = _jax_tp_step(workdir / "tp", b,
                                     TRAINING_PRECISION="bf16")
    grads = single["vit"]["grads"][0]
    for res in tp_ranks:
        out = res["tp_vit_bf16"]
        np.testing.assert_allclose(out["metrics"][0][0], loss, rtol=0,
                                   atol=5e-2 * abs(loss))
        assert out["metrics"][0][2] == count
        for key, w in want.items():
            diff = (out["state"][key] - w).abs()
            bad = diff > 5e-2 * max(float(w.abs().max()), 1e-6)
            noise = grads[key].abs() <= 2.0 ** -6 * grads[key].abs().max()
            assert (noise[bad]).all() and (diff[bad] <= 2 * LR).all(), key
    _same_on_every_rank(tp_ranks, "tp_vit_bf16")


def test_tp_step_matches_one_process(tp_ranks, single):
    """The dp 2 x tp 2 step against the port's one-process step on the
    same weights and batch: the loss, the gathered gradients and the
    parameters at the module's bounds."""
    for res in tp_ranks:
        _hold_losses(res["tp_vit"]["metrics"], single["vit"]["metrics"])
        _hold_grads(res["tp_vit"]["grads"], single["vit"]["grads"])
        _hold_state(res["tp_vit"]["state"], single["vit"]["state"],
                    grads=single["vit"]["grads"][-1])


@pytest.mark.parametrize("case", ["fourd", "fourd_int8"])
def test_tp_fourd_step_matches_one_process(tp_ranks, single, case):
    """tests/test_sharding.py:113's counterpart: two 4D steps with the
    frozen encoder tensor-parallel over the model axis and the B·T stream
    split over the data axis (plain and int8 encoders) against one
    process, at the module's 4D bounds; every rank's state equal."""
    for res in tp_ranks:
        got = res[f"tp_{case}"]
        _hold_losses(got["metrics"], single[case]["metrics"])
        _hold_grads(got["grads"], single[case]["grads"], floor=1.0)
        _hold_state(got["state"], single[case]["state"],
                    grads=single[case]["grads"][-1])
    _same_on_every_rank(tp_ranks, f"tp_{case}")


def test_tp_resnet_padded_step(tp_ranks, workdir):
    """The ResNet has no tensor-parallel rule: replicated over the model
    axis, its global BatchNorm summed over the data group only. At global
    batch 5 on a data axis of 2 the batch is padded to 6 as JAX pads it,
    and the pad row counts in the batch statistics as in JAX's padded
    step: the step equals one process's step on the padded batch (the
    port's one-process ResNet step is JAX's, tests/test_torch_resnet.py);
    every rank holds the same state."""
    config = worker.tiny_config(str(workdir / "tp_resnet"),
                                MODEL_VOLUME_ENCODER="resnet",
                                MODEL_RESNET_DEPTH=10, TRAINING_BATCH_SIZE=6,
                                DATASET_NAME="adni")
    trainer = worker._trainer(config, worker.Volumes(16, classes=2), seed=2)
    padded = sharding.pad_batch(worker.global_batches(1, b=5, classes=2)[0],
                                2)
    want = worker._steps(trainer, [padded])
    for res in tp_ranks:
        got = res["tp_resnet_pad"]
        _hold_losses(got["metrics"], want["metrics"])
        _hold_grads(got["grads"], want["grads"])
        _hold_state(got["state"], want["state"], grads=want["grads"][0])
        assert got["metrics"][0][2] == 5
    _same_on_every_rank(tp_ranks, "tp_resnet_pad")


def test_tp_dropout_keys(tp_ranks):
    """The step seed folds in the data index only: the two model ranks of
    a data index draw one step seed, and the row-parallel sites (the
    out-projection, the MLP output) one key; the column-parallel sites
    (the probabilities of the shard's heads, the hidden of its columns)
    a key per model index, each at the keep rate; data indices differ."""
    by_mesh = {res["tp_dropout"]["mesh"]: res["tp_dropout"]["keys"]
               for res in tp_ranks}
    assert sorted(by_mesh) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for d in (0, 1):
        k0, k1 = by_mesh[(d, 0)], by_mesh[(d, 1)]
        assert k0["step"] == k1["step"]
        assert k0["outproj"] == k1["outproj"] and len(k0["outproj"]) == 2
        assert k0["mlp_out"] == k1["mlp_out"]
        for site in ("probs", "hidden"):
            assert len(k0[site]) == 2
            assert not set(k0[site]) & set(k1[site])
            for key in k0[site] + k1[site]:
                rate = float(nn.keep_mask(key, (8, 126, 2, 16), 0.1)
                             .float().mean())
                assert abs(rate - 230 / 256) < 0.01
        assert not set(k0["probs"]) & set(k0["outproj"])
    assert by_mesh[(0, 0)]["step"] != by_mesh[(1, 0)]["step"]
    assert by_mesh[(0, 0)]["outproj"] != by_mesh[(1, 0)]["outproj"]


def test_tp_checkpoint_is_whole_and_restores(tp_ranks):
    """Rank 0 writes the train state whole: its weight file loads strictly
    into a one-process model, the AdamW moments are whole; every rank
    restores it into other weights, cut again to its shard (moments too),
    bit-equal to the trainer that wrote it, and the next step of each
    matches."""
    from neurovit_tpu_torch.training import checkpoint as ckpt
    out = tp_ranks[0]["tp_restore"]
    assert out["files"] == ["state", "state.state_dict.pkl"]
    config = worker.tiny_config(os.path.dirname(out["path"]))
    model = NeuroEncoder(config, device="cpu")
    ckpt.load_checkpoint(model, out["path"] + ".state_dict.pkl",
                         strict=True)
    state = ckpt.load_train_state(out["path"])
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == shapes
    moments = [tuple(st["exp_avg"].shape)
               for st in state["optimizer"]["adamw"]["state"].values()]
    assert sorted(moments) == sorted(
        tuple(p.shape) for p in model.parameters())
    for res in tp_ranks:
        got = res["tp_restore"]
        for key, value in got["restored"].items():
            assert torch.equal(value, tp_ranks[0]["tp_restore"]["restored"]
                               [key]), key
        for key, value in got["after"].items():
            assert torch.equal(value, got["want"][key]), key
        assert got["moment_shapes"] == tp_ranks[0]["tp_restore"][
            "moment_shapes"]
    assert (32 * 3, 64) in tp_ranks[0]["tp_restore"]["moment_shapes"]


def test_dryrun_multichip_on_the_group(tp_ranks):
    """neurovit_tpu_torch.dryrun.dryrun_multichip(4) on the dp 2 x tp 2
    group: JAX's dp x tp parts with its oracle and bounds pass, each with
    its summary line, and one line says the GPipe parts wait."""
    lines = tp_ranks[0]["tp_dryrun"]["lines"]
    assert any("3D mesh={'data': 2, 'model': 2, 'pipe': 1}" in line
               and "params match) OK" in line for line in lines)
    assert any("4D mesh=" in line and "params match) OK" in line
               for line in lines)
    assert any("int8 predictor x dp-x-tp mesh" in line for line in lines)
    assert any("4D feature cache x mesh" in line for line in lines)
    waits = [line for line in lines if "wait for ROADMAP.md Queue 1" in line]
    assert len(waits) == 1 and "not run" in waits[0]
    for res in tp_ranks[1:]:
        assert res["tp_dryrun"]["lines"] == []
