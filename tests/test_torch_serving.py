"""The port's serving surface on the CPU plain path, at the tiny 3D ViT
(grid 20, patch 5, dim 64, depth 2): bucket routing, parity with the JAX
Predictor on one checkpoint, the batch CLI and the HTTP server."""

import gzip
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
import yaml

from neurovit_tpu.config import load_config
from neurovit_tpu.data import nifti
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.serving import Predictor as JaxPredictor
from neurovit_tpu.training import state_dict as jax_state_dict
from neurovit_tpu_torch import serving
from neurovit_tpu_torch.serving import Predictor, _collect_volume_jobs
from neurovit_tpu_torch.serving_http import make_server

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny f32 config and a checkpoint written by the JAX package."""
    tmp = tmp_path_factory.mktemp("torch_serving")
    config = load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32",
        "TRAINING_DROPOUT": 0.0, "MODEL_VIT_DIM": 64, "MODEL_VIT_DEPTH": 2,
        "MODEL_VIT_HEADS": 4, "MODEL_VIT_DIM_HEAD": 16,
        "MODEL_VIT_MLP_DIM": 128, "KERNEL_IMPL": "xla"})
    jmodel = JaxNeuroEncoder(config)
    params = jmodel.init(jax.random.key(9))["params"]
    ckpt = str(tmp / "model.state_dict.pkl")
    jax_state_dict.save(ckpt, jax_state_dict.to_state_dict(jmodel, params))
    return config, ckpt, tmp


def _vols(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 20, 20, 20)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 3, 9])
def test_bucket_routing_and_padding_parity(setup, n):
    """Every request size, routed through buckets (1, 2) below batch 4 and
    padded by repeating its last volume, gives the single-call results."""
    config, ckpt, _ = setup
    predictor = Predictor.from_checkpoint(config, ckpt, batch_size=4,
                                          bucket_sizes=(1, 2), device="cpu")
    assert predictor.bucket_sizes == (1, 2, 4)
    vols = _vols(n, n)
    labels, probs = predictor(vols)
    assert labels.shape == (n,) and probs.shape == (n, 2)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    for i in range(n):
        _, one = predictor(vols[i:i + 1])
        np.testing.assert_allclose(one[0], probs[i], atol=1e-6)
    np.testing.assert_array_equal(labels, probs.argmax(axis=1))


def test_probabilities_match_jax_predictor(setup):
    config, ckpt, _ = setup
    vols = _vols(11, 5)
    _, want = JaxPredictor.from_checkpoint(config, ckpt, batch_size=4)(vols)
    _, got = Predictor.from_checkpoint(config, ckpt, batch_size=4,
                                       device="cpu")(vols)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_host_bf16_needs_bf16_compute(setup):
    config, ckpt, _ = setup
    with pytest.raises(ValueError, match="bf16"):
        Predictor.from_checkpoint(config, ckpt, host_transfer_dtype="bf16",
                                  device="cpu")


def test_cuda_device_without_cuda_raises(setup, monkeypatch):
    """No silent drop to the CPU when the card is missing."""
    config, ckpt, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor.from_checkpoint(config, ckpt)


def _write_config(config, tmp):
    path = tmp / "tiny.yaml"
    path.write_text(yaml.safe_dump(dict(config)))
    return str(path)


def test_cli_writes_csv(setup, tmp_path):
    config, ckpt, tmp = setup
    # (21, 39, 21, 2): the ADNI crop [1:, 10:-9, 1:] yields 20^3, two
    # timepoints -> two rows.
    scan = str(tmp_path / "scan.nii")
    nifti.save(scan, np.random.default_rng(2).standard_normal(
        (21, 39, 21, 2)).astype(np.float32))
    out = tmp_path / "pred.csv"
    serving.main([scan, "--config", _write_config(config, tmp),
                  "--checkpoint", ckpt, "--output", str(out),
                  "--batch-size", "4", "--device", "cpu"])
    rows = out.read_text().strip().splitlines()
    assert rows[0] == "path,timepoint,prediction,prob_0,prob_1"
    assert [r.split(",")[1] for r in rows[1:]] == ["0", "1"]

    vols = np.stack([v for _, _, v in _collect_volume_jobs([scan], True)])
    _, want = Predictor.from_checkpoint(config, ckpt, batch_size=4,
                                        device="cpu")(vols)
    got = np.array([[float(p) for p in r.split(",")[3:]] for r in rows[1:]])
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("flag,item", [("--mesh", "multi-GPU"),
                                       ("--quant=int8", "int8 serving")])
def test_cli_refuses_unported_flags(setup, tmp_path, capsys, flag, item):
    config, ckpt, tmp = setup
    with pytest.raises(SystemExit):
        serving.main([str(tmp_path), "--config", _write_config(config, tmp),
                      "--checkpoint", ckpt, "--device", "cpu", flag])
    assert item in capsys.readouterr().err


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_healthz_and_predict(setup, tmp_path):
    config, ckpt, _ = setup
    predictor = Predictor.from_checkpoint(config, ckpt, batch_size=4,
                                          bucket_sizes=(1, 2), device="cpu")
    scan = str(tmp_path / "scan.nii")
    nifti.save(scan, np.random.default_rng(3).standard_normal(
        (21, 39, 21)).astype(np.float32))
    _, _, vol = next(_collect_volume_jobs([scan], crop=True))
    _, want = predictor(vol[None])

    server, batcher = make_server(predictor, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read()) == {
                "status": "ok", "is_4d": False, "batch_size": 4,
                "buckets": [1, 2, 4], "quant": None}
        body = open(scan, "rb").read()
        for payload in (body, gzip.compress(body)):
            status, out = _post(url + "/predict", payload)
            assert status == 200
            (row,) = out["rows"]
            assert row["timepoint"] == 0
            assert row["prediction"] == int(want[0].argmax())
            np.testing.assert_allclose(row["probs"], want[0], atol=1e-6)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/predict", b"not a nifti")
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/nope", body)
        assert err.value.code == 404
    finally:
        server.shutdown()
        batcher.stop()
        thread.join(timeout=10)
        server.server_close()
    assert not thread.is_alive()
