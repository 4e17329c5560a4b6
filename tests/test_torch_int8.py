"""The port's int8 serving (plain PyTorch on the CPU) against the JAX
package's int8 path (its Pallas kernels in interpret mode), on the same
numpy inputs, at the sizes of tests/test_int8_serving.py: DIM 64, 4 heads
of 16, MLP 128.

Tolerances. Ops: relative Frobenius error <= 1e-3 at f32 and <= 2e-2 at
bf16. Model logits: 1e-3 at f32, 5e-2 at bf16. Both sides take the same
exact int32 products; an f32 LayerNorm, GELU or sum taken in another order
can move a code by one quantization step now and then, and bf16 outputs
then by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.config import load_config
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.models import vit3d as jvit
from neurovit_tpu.ops import int8_serving as jq
from neurovit_tpu.serving import Predictor as JaxPredictor
from neurovit_tpu.training import state_dict as jax_state_dict
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.models.vit3d import (Int8Attention, Int8FeedForward,
                                             quantize_blocks)
from neurovit_tpu_torch.ops import int8_serving as q8
from neurovit_tpu_torch.ops.flash_attention import flash_attention
from neurovit_tpu_torch.serving import Predictor
from neurovit_tpu_torch.training.state_dict import PREFIX, from_jax_params

torch.set_num_threads(1)

B, N, DIM, HEADS, DIM_HEAD, HID = 2, 30, 64, 4, 16, 128
INNER = HEADS * DIM_HEAD
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
LOGIT_TOL = {"f32": dict(rtol=1e-3, atol=1e-3),
             "bf16": dict(rtol=0, atol=5e-2)}


def _rel(got: torch.Tensor, want) -> float:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


def _act(rng, shape, jdt, gain=1.0):
    """One activation for both packages, rounded to the dtype once in JAX."""
    a = (gain * rng.standard_normal(shape)).astype(np.float32)
    j = jnp.asarray(a).astype(jdt)
    return j, np.asarray(j.astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _linear(rng, fan_in, fan_out):
    """JAX layout [in, out] + bias, nn.Linear's default range."""
    bound = fan_in ** -0.5
    return (rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
            rng.uniform(-bound, bound, fan_out).astype(np.float32))


def _ln_params(rng):
    return ((1.0 + 0.2 * rng.standard_normal(DIM)).astype(np.float32),
            (0.1 * rng.standard_normal(DIM)).astype(np.float32))


def _both_quantized(w):
    """JAX's (w8 [in, out], scale [1, out]) and the port's (w8 [out, in],
    scale [out]) of one [in, out] weight."""
    jw8, js = jq.quantize_weight(jnp.asarray(w))
    w8, s = q8.quantize_weight(_t(w.T))
    return {"w": jw8, "scale": js}, (w8, s)


# ---------------------------------------------------------------------------
# (a) weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,key", [("qkv", "0.to_qkv.weight"),
                                      ("attn_out", "0.to_out.0.weight"),
                                      ("fc1", "1.net.1.weight"),
                                      ("fc2", "1.net.4.weight")])
def test_quantize_weight_matches_jax_bit_for_bit(name, key):
    """The port's w8 is JAX's w8 transposed and its scales are JAX's, bit
    for bit, from the f32 weights that from_jax_params hands over; a zero
    output channel gets zero codes and scale 1."""
    cfg = jvit.ViTConfig(image_size=20, image_patch_size=5, frames=20,
                         frame_patch_size=5, num_classes=2, dim=DIM, depth=2,
                         heads=HEADS, dim_head=DIM_HEAD, mlp_dim=HID)
    params = jax.tree.map(np.array, jvit.init(jax.random.key(1), cfg))
    params["blocks"][name]["kernel"][:, :, 0] = 0.0
    jw8, js = jq.quantize_weight(params["blocks"][name]["kernel"])
    sd = from_jax_params({"volume_encoder": params})
    for i in range(cfg.depth):
        w8, s = q8.quantize_weight(sd[f"{PREFIX}transformer.layers.{i}.{key}"])
        assert w8.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8[i]).T)
        np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                      np.asarray(js[i, 0]).view(np.uint32))
        assert not w8[0].any() and float(s[0]) == 1.0


# ---------------------------------------------------------------------------
# (b) ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_ln_qkv_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(10)
    xj, xn = _act(rng, (B, N, DIM), jdt)
    gamma, beta = _ln_params(rng)
    w, _ = _linear(rng, DIM, 3 * INNER)
    jw, (w8, s) = _both_quantized(w)
    block = {"attn_norm": {"scale": jnp.asarray(gamma),
                           "bias": jnp.asarray(beta)}, "qkv_q8": jw}
    want = jq.int8_ln_qkv(block, xj, HEADS, DIM_HEAD)
    got = q8.int8_ln_qkv(_t(xn, tdt), _t(gamma), _t(beta), w8, s, HEADS,
                         DIM_HEAD)
    for g, wj in zip(got, want):
        assert g.shape == (B, N, HEADS, DIM_HEAD) and g.dtype == tdt
        assert _rel(g, wj) <= tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_outproj_residual_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(11)
    xj, xn = _act(rng, (B, N, DIM), jdt)
    aj, an = _act(rng, (B, N, INNER), jdt)
    w, b = _linear(rng, INNER, DIM)
    jw, (w8, s) = _both_quantized(w)
    want = jq.int8_outproj_residual({**jw, "bias": jnp.asarray(b)}, xj, aj)
    got = q8.int8_outproj_residual(_t(xn, tdt), _t(an, tdt), w8, s, _t(b))
    assert got.shape == (B, N, DIM) and got.dtype == tdt
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_mlp_block_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(12)
    xj, xn = _act(rng, (B, N, DIM), jdt)
    gamma, beta = _ln_params(rng)
    w1, b1 = _linear(rng, DIM, HID)
    w2, b2 = _linear(rng, HID, DIM)
    jw1, (w1_8, s1) = _both_quantized(w1)
    jw2, (w2_8, s2) = _both_quantized(w2)
    block = {"mlp_norm": {"scale": jnp.asarray(gamma),
                          "bias": jnp.asarray(beta)},
             "fc1_q8": {**jw1, "bias": jnp.asarray(b1)},
             "fc2_q8": {**jw2, "bias": jnp.asarray(b2)}}
    want = jq.int8_mlp_block(block, xj)
    got = q8.int8_mlp_block(_t(xn, tdt), _t(gamma), _t(beta), w1_8, s1,
                            _t(b1), w2_8, s2, _t(b2))
    assert got.shape == (B, N, DIM) and got.dtype == tdt
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_valid", [None, 20])
@pytest.mark.parametrize("q_gain", [1.0, 4.0])
def test_int8_flash_attention_matches_jax(dtype, n_valid, q_gain):
    """q_gain 4 makes the rows strongly peaked (tests/test_int8_serving.py:
    97-115). With n_valid, V's rows past it are zero here: JAX's per-channel
    V scale spans every row it is given (int8_serving.py:315), the port's
    only the valid keys (ROADMAP, Queue 3), and zero rows leave both the
    same."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(13)
    (qj, qn), (kj, kn) = (_act(rng, (B, N, HEADS, DIM_HEAD), jdt, g)
                          for g in (q_gain, 1.0))
    v = rng.standard_normal((B, N, HEADS, DIM_HEAD)).astype(np.float32)
    if n_valid is not None:
        v[:, n_valid:] = 0.0
    vj = jnp.asarray(v).astype(jdt)
    vn = np.asarray(vj.astype(jnp.float32))
    scale = DIM_HEAD ** -0.5
    want = jq.int8_flash_attention(qj, kj, vj, scale=scale, n_valid=n_valid)
    got = q8.int8_flash_attention(_t(qn, tdt), _t(kn, tdt), _t(vn, tdt),
                                  scale=scale, n_valid=n_valid)
    assert got.shape == (B, N, HEADS, DIM_HEAD) and got.dtype == tdt
    assert _rel(got, want) <= tol


def test_int8_flash_attention_ignores_keys_past_n_valid():
    """Keys at or past n_valid neither weigh in nor set V's scale."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 17, HEADS, DIM_HEAD))
                                .astype(np.float32)) for _ in range(3))
    out = q8.int8_flash_attention(q, k, v, scale=0.25, n_valid=11)
    k2, v2 = k.clone(), v.clone()
    k2[:, 11:] = 100.0
    v2[:, 11:] = -70.0
    assert torch.equal(out, q8.int8_flash_attention(q, k2, v2, scale=0.25,
                                                    n_valid=11))


def test_int8_flash_attention_tiny_head_takes_bf16_attention():
    """D < 8 (and N > 4096) take the bf16 attention, as the JAX wrapper
    chooses by shape (int8_serving.py:343-347)."""
    rng = np.random.default_rng(15)
    (qj, qn), (kj, kn), (vj, vn) = (_act(rng, (1, 12, 1, 2), jnp.float32)
                                    for _ in range(3))
    got = q8.int8_flash_attention(_t(qn), _t(kn), _t(vn), scale=2 ** -0.5)
    assert torch.equal(got, flash_attention(_t(qn), _t(kn), _t(vn),
                                            scale=2 ** -0.5))
    want = jq.int8_flash_attention(qj, kj, vj, scale=2 ** -0.5)
    assert _rel(got, want) <= 1e-3


# ---------------------------------------------------------------------------
# (c) the whole quantized model
# ---------------------------------------------------------------------------

def _config(precision="f32", **extra):
    return load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": precision,
        "TRAINING_DROPOUT": 0.0, "MODEL_VIT_DIM": DIM, "MODEL_VIT_DEPTH": 2,
        "MODEL_VIT_HEADS": HEADS, "MODEL_VIT_DIM_HEAD": DIM_HEAD,
        "MODEL_VIT_MLP_DIM": HID, "KERNEL_IMPL": "xla", **extra})


def _volumes(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 20, 20, 20)).astype(np.float32)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("attn", [True, False])
def test_quantized_model_matches_jax(precision, attn):
    """The quantized NeuroEncoder against JAX's with quantize_blocks on the
    xla impl, which runs the same int8 kernels on the unpadded token
    stream (vit3d.py:450), for SERVING_INT8_ATTN on (K13) and off (K1)."""
    config = _config(precision, SERVING_INT8_ATTN=attn)
    jmodel = JaxNeuroEncoder(config)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(3))["params"])
    ve = params["volume_encoder"]
    qparams = {**params, "volume_encoder": {
        **ve, "blocks": jq.quantize_blocks(ve["blocks"])}}
    vols = _volumes(4)
    want, _ = jmodel.apply(qparams, jnp.asarray(vols))

    model = NeuroEncoder(config, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    quantize_blocks(model.volume_encoder.vit3d)
    assert model.vit_cfg.int8_attn == ("pv" if attn else "off")
    with torch.no_grad():
        got = model(torch.from_numpy(vols))
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **LOGIT_TOL[precision])


# ---------------------------------------------------------------------------
# (d) SERVING_INT8_ATTN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw,mode", [(None, "pv"), ("pv", "pv"),
                                      ("off", "off"), ("OFF", "off"),
                                      (True, "pv"), (False, "off")])
def test_serving_int8_attn_parsing(raw, mode, monkeypatch):
    """As neurovit_tpu/models/neuro_encoder.py:74-84 parses it; the JAX
    package's NEUROVIT_INT8_ATTN default is not read."""
    monkeypatch.setenv("NEUROVIT_INT8_ATTN", "off")
    extra = {} if raw is None else {"SERVING_INT8_ATTN": raw}
    assert NeuroEncoder(_config(**extra), device="cpu").vit_cfg.int8_attn \
        == mode


def test_serving_int8_attn_rejects_unknown_values():
    with pytest.raises(ValueError, match="SERVING_INT8_ATTN"):
        NeuroEncoder(_config(SERVING_INT8_ATTN="bogus"), device="cpu")


# ---------------------------------------------------------------------------
# (e) serving only, the f32 GEMM weights gone
# ---------------------------------------------------------------------------

def test_quantized_model_is_serving_only():
    model = NeuroEncoder(_config(TRAINING_DROPOUT=0.1), device="cpu")
    vit = quantize_blocks(model.volume_encoder.vit3d)
    vols = torch.from_numpy(_volumes(5))
    with pytest.raises(ValueError, match="serving-only"):
        model(vols, train=True, seed=1)
    attn, ff = vit.transformer.layers[0]
    with pytest.raises(ValueError, match="serving-only"):
        ff(torch.zeros(1, 3, DIM), 0.1)
    with pytest.raises(ValueError, match="serving-only"):
        attn(torch.zeros(1, 3, DIM), 0.1)
    with pytest.raises(ValueError, match="already quantized"):
        quantize_blocks(vit)


def test_quantized_blocks_drop_the_float_weights():
    model = NeuroEncoder(_config(), device="cpu")
    vit = quantize_blocks(model.volume_encoder.vit3d)
    assert vit.quantized
    for attn, ff in vit.transformer.layers:
        assert isinstance(attn, Int8Attention)
        assert isinstance(ff, Int8FeedForward)
        assert not list(attn.parameters()) and not list(ff.parameters())
        for name in ("qkv_w8", "out_w8"):
            assert getattr(attn, name).dtype == torch.int8
        for name in ("fc1_w8", "fc2_w8"):
            assert getattr(ff, name).dtype == torch.int8
    keys = model.state_dict().keys()
    assert not [k for k in keys if k.endswith(("to_qkv.weight",
                                                "to_out.0.weight",
                                                "net.1.weight",
                                                "net.4.weight"))]
    assert (f"{PREFIX}transformer.layers.0.0.qkv_w8" in keys
            and f"{PREFIX}transformer.layers.1.1.fc2_w8" in keys)


# ---------------------------------------------------------------------------
# Predictor(quant="int8")
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    config = _config()
    jmodel = JaxNeuroEncoder(config)
    params = jmodel.init(jax.random.key(7))["params"]
    path = str(tmp_path_factory.mktemp("int8") / "model.state_dict.pkl")
    jax_state_dict.save(path, jax_state_dict.to_state_dict(jmodel, params))
    return config, path


def test_int8_predictor_matches_jax_and_stays_near_full_precision(checkpoint):
    """The int8 Predictor against JAX's int8 Predictor on one checkpoint,
    and within the JAX test's 0.05 of the full-precision Predictor
    (tests/test_int8_serving.py:205)."""
    config, path = checkpoint
    vols = _volumes(6, 6)
    p_int8 = Predictor.from_checkpoint(config, path, batch_size=4,
                                       device="cpu", quant="int8")
    assert p_int8.quant == "int8"
    assert p_int8.model.volume_encoder.vit3d.quantized
    _, got = p_int8(vols)
    _, want = JaxPredictor.from_checkpoint(config, path, batch_size=4,
                                           quant="int8")(vols)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    _, full = Predictor.from_checkpoint(config, path, batch_size=4,
                                        device="cpu")(vols)
    np.testing.assert_allclose(got, full, atol=0.05)


# ---------------------------------------------------------------------------
# (f) fidelity on a trained model
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_int8_fidelity_on_trained_model(tiny_config, tmp_path):
    """tests/test_int8_serving.py:285-328 on the port: train the tiny model
    on the synthetic cube task, quantize the trained weights, and hold the
    eval-sweep accuracy, the argmax flips and the probabilities to the JAX
    test's bounds."""
    from neurovit_tpu.data import get_datasets
    from neurovit_tpu_torch.training import Trainer
    from neurovit_tpu_torch.training import state_dict as sd

    config = dict(tiny_config)
    config.update({"TRAINING_EPOCHS": 3, "TRAINING_LEARNING_RATE": 1e-3,
                   "GRADCAM_NUM_SAMPLES": 200, "DATASET_GENERATE": True})
    ds_train, ds_val = get_datasets(config)
    model = NeuroEncoder(config, device="cpu")
    trainer = Trainer(config, model, ds_train, ds_val)
    trainer.run()
    acc_ref = trainer.evaluate_samples()
    assert acc_ref > 0.9, f"trained accuracy too low to test: {acc_ref}"

    path = str(tmp_path / "trained.pkl")
    sd.save(path, model.state_dict())
    p_full = Predictor.from_checkpoint(config, path, batch_size=8,
                                       device="cpu")
    p_int8 = Predictor.from_checkpoint(config, path, batch_size=8,
                                       device="cpu", quant="int8")
    vols = np.stack([ds_val.sample(i)["volume"] for i in range(len(ds_val))])
    labels = np.array([ds_val.sample(i)["label"] for i in range(len(ds_val))])
    pred_full, probs_full = p_full(vols)
    pred_int8, probs_int8 = p_int8(vols)
    acc_full = float((pred_full == labels).mean())
    acc_int8 = float((pred_int8 == labels).mean())
    flips = int((pred_full != pred_int8).sum())
    print(f"int8 fidelity: full acc {acc_full:.4f}, int8 acc {acc_int8:.4f}, "
          f"argmax flips {flips}/{len(labels)}")
    assert abs(acc_full - acc_int8) <= 1.0 / len(labels) + 1e-9
    assert flips <= 1
    np.testing.assert_allclose(probs_int8, probs_full, atol=0.06)
