"""The port's sequence serving (4D checkpoints) on the CPU plain path, at the
tiny ViT (grid 20, patch 5, dim 64, depth 2) with the temporal head:
sequence jobs against JAX's ``_collect_volume_jobs(sequence=True)``, the
Predictor on [N, H, W, D, T] against the JAX Predictor on one checkpoint
(f32, within 1e-3) and across its buckets, the 4D default batch of 2, the
batch CLI's timepoint -1 rows, int8 serving within 0.05 of bf16 (the JAX
test's bound) and ``/healthz``'s ``is_4d``."""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
import yaml

from neurovit_tpu import serving as jax_serving
from neurovit_tpu.config import load_config
from neurovit_tpu.data import nifti
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.training import state_dict as jax_state_dict
from neurovit_tpu_torch import serving
from neurovit_tpu_torch.serving import Predictor, _collect_volume_jobs
from neurovit_tpu_torch.serving_http import make_server

torch.set_num_threads(1)

T = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny f32 4D config and a checkpoint written by the JAX package."""
    tmp = tmp_path_factory.mktemp("torch_serving_4d")
    config = load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "TRAINING_DIM": 4, "DATASET_NAME": "adni4D",
        "TRAINING_PRECISION": "f32", "TRAINING_DROPOUT": 0.0,
        "MODEL_TEMPORAL_DROPOUT": 0.0, "MODEL_VIT_DIM": 64,
        "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4, "MODEL_VIT_DIM_HEAD": 16,
        "MODEL_VIT_MLP_DIM": 128, "KERNEL_IMPL": "xla"})
    jmodel = JaxNeuroEncoder(config)
    params = jax.jit(jmodel.init)(jax.random.key(9))["params"]
    ckpt = str(tmp / "model4d.state_dict.pkl")
    jax_state_dict.save(ckpt, jax_state_dict.to_state_dict(jmodel, params))
    return config, ckpt, tmp


def _series(seed, n, t=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 20, 20, 20, t)).astype(np.float32)
    for i in range(t):
        x[:, 2 + 3 * i:8 + 3 * i, 4:12, 4:12, i] += 3.0
    return x


def _write_scans(tmp_path):
    """A 4D series (21, 39, 21, T) and a 3D scan: the ADNI crop [1:, 10:-9,
    1:] gives 20^3."""
    rng = np.random.default_rng(2)
    scans = [str(tmp_path / "series.nii"), str(tmp_path / "scan3d.nii")]
    nifti.save(scans[0], (rng.standard_normal((21, 39, 21, T)) * 3 + 1
                          ).astype(np.float32))
    nifti.save(scans[1], rng.standard_normal((21, 39, 21)).astype(
        np.float32))
    return scans


@pytest.mark.parametrize("crop", [True, False])
def test_sequence_jobs_match_jax(tmp_path, crop):
    """One whole series per file, z-scored over the whole 4D array, as
    timepoint -1; a 3D file is a series of T = 1."""
    scans = _write_scans(tmp_path)
    got = list(_collect_volume_jobs(scans, crop=crop, sequence=True))
    want = list(jax_serving._collect_volume_jobs(scans, crop=crop,
                                                 sequence=True))
    assert len(got) == len(want) == 2
    for (gp, gt, gv), (wp, wt, wv) in zip(got, want):
        assert gp == wp and gt == wt == -1
        assert gv.shape == wv.shape and gv.dtype == np.float32
        np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-6)
    assert got[0][2].shape[-1] == T and got[1][2].shape[-1] == 1
    # The 3D path is unchanged: one volume per timepoint.
    assert [t for _, t, _ in _collect_volume_jobs(scans, crop=crop)] == \
        list(range(T)) + [0]


def test_predictor_on_sequences_matches_jax(setup):
    config, ckpt, _ = setup
    predictor = Predictor.from_checkpoint(config, ckpt, batch_size=2,
                                          device="cpu")
    assert predictor.bucket_sizes == (1, 2) and predictor.model.is_4d
    jax_predictor = jax_serving.Predictor.from_checkpoint(config, ckpt,
                                                          batch_size=2)
    seqs = _series(1, 3)
    labels, probs = predictor(seqs)
    assert labels.shape == (3,) and probs.shape == (3, 2)
    _, want = jax_predictor(seqs)
    np.testing.assert_allclose(probs, want, atol=1e-3)
    for i in range(3):                        # bucket 1 against buckets 2
        _, one = predictor(seqs[i:i + 1])
        np.testing.assert_allclose(one[0], probs[i], atol=1e-6)
    predictor.warmup(seq_len=T)


def test_default_batch_is_two_sequences(setup):
    config, ckpt, tmp = setup
    assert serving._default_batch_size(True) == 2
    assert serving._default_batch_size(False) == 128
    import argparse
    parser = argparse.ArgumentParser()
    serving.add_serving_args(parser)
    args = parser.parse_args(["--checkpoint", ckpt, "--device", "cpu"])
    args.batch_size = None
    predictor = serving.predictor_from_cli_args(parser, args, config)
    assert predictor.batch_size == 2 and predictor.bucket_sizes == (1, 2)


def _write_config(config, tmp):
    path = tmp / "config4d.yaml"
    path.write_text(yaml.safe_dump(dict(config)))
    return str(path)


def test_cli_writes_one_row_per_series(setup, tmp_path):
    """The batch CLI on a 4D checkpoint: one row per file, timepoint -1,
    with the Predictor's probabilities; then with --quant int8 within 0.05
    of them."""
    config, ckpt, tmp = setup
    scans = _write_scans(tmp_path)[:1] + [str(tmp_path / "series2.nii")]
    nifti.save(scans[1], np.random.default_rng(5).standard_normal(
        (21, 39, 21, T)).astype(np.float32))
    out = tmp_path / "pred.csv"
    serving.main(scans + ["--config", _write_config(config, tmp),
                          "--checkpoint", ckpt, "--output", str(out),
                          "--device", "cpu"])
    rows = out.read_text().strip().splitlines()
    assert rows[0] == "path,timepoint,prediction,prob_0,prob_1"
    assert [r.split(",")[:2] for r in rows[1:]] == [[s, "-1"] for s in scans]
    seqs = np.stack([v for _, _, v in _collect_volume_jobs(
        scans, True, sequence=True)])
    _, want = Predictor.from_checkpoint(config, ckpt, device="cpu")(seqs)
    got = np.array([[float(p) for p in r.split(",")[3:]] for r in rows[1:]])
    np.testing.assert_allclose(got, want, atol=1e-5)

    out8 = tmp_path / "pred8.csv"
    config8 = dict(config, TRAINING_PRECISION="bf16")
    serving.main(scans + ["--config", _write_config(config8, tmp_path),
                          "--checkpoint", ckpt, "--output", str(out8),
                          "--device", "cpu", "--quant", "int8"])
    rows8 = out8.read_text().strip().splitlines()
    got8 = np.array([[float(p) for p in r.split(",")[3:]]
                     for r in rows8[1:]])
    _, bf16 = Predictor.from_checkpoint(config8, ckpt, device="cpu")(seqs)
    np.testing.assert_allclose(got8, bf16, atol=0.05)


def test_http_healthz_and_predict_a_series(setup, tmp_path):
    config, ckpt, _ = setup
    predictor = Predictor.from_checkpoint(config, ckpt, batch_size=2,
                                          device="cpu")
    scan = _write_scans(tmp_path)[0]
    _, _, series = next(_collect_volume_jobs([scan], crop=True,
                                             sequence=True))
    _, want = predictor(series[None])
    server, batcher = make_server(predictor, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read()) == {
                "status": "ok", "is_4d": True, "batch_size": 2,
                "buckets": [1, 2], "quant": None}
        req = urllib.request.Request(url + "/predict",
                                     data=open(scan, "rb").read(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            (row,) = json.loads(resp.read())["rows"]
        assert row["timepoint"] == -1
        assert row["prediction"] == int(want[0].argmax())
        np.testing.assert_allclose(row["probs"], want[0], atol=1e-6)
    finally:
        server.shutdown()
        batcher.stop()
        thread.join(timeout=10)
        server.server_close()
