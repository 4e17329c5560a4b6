"""Tensor parallelism of the port's ViT blocks, in one process: the mesh's
rank layout and subgroups, the shard rules (cut, gather, refusals, int8),
the tensor-parallel forms' plain versions against the whole passes, the
dropout keys, the padded sharded loader, and serving over a model axis of
CPU copies against one replica and against the JAX Predictor on a dp x tp
mesh of virtual devices.

Tolerances: f32 sums of the shards' partials against the whole pass
within 1e-5 relative + 1e-6 absolute (the same exact products summed in
another order); at bf16, the f32 sum rounded once, within one bf16 ulp
(2^-7 relative) + 1e-5 absolute; the split int8 row-quantize's codes equal
to the one-shot codes bit for bit, and the int8 passes from the shards'
int32 sums equal to one card's. Serving: f32 logits within JAX's 2e-3
(tests/test_sharding.py:176-178); int8 probabilities within 1e-4 with
labels equal (tests/test_int8_serving.py:253-254), int8 logits equal to
one replica's; bf16 probabilities
within 2e-2, the port's bf16 serving bound six blocks deep (chip_smoke.py
PROB_ATOL).
"""

import copy

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from neurovit_tpu.config import load_config as jax_load_config
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.parallel import create_mesh as jax_create_mesh
from neurovit_tpu.serving import Predictor as JaxPredictor
from neurovit_tpu.training import state_dict as jax_state_dict
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.data.loader import DataLoader
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.models.vit3d import ViT3D, ViTConfig, quantize_blocks
from neurovit_tpu_torch.ops import fused_mlp, fused_outproj, fused_qkv
from neurovit_tpu_torch.ops import int8_serving as q8
from neurovit_tpu_torch.ops import tp_forms as F
from neurovit_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                         create_mesh, distributed, mesh,
                                         sharding)
from neurovit_tpu_torch.parallel import tensor_parallel as tp
from neurovit_tpu_torch.serving import Predictor

torch.set_num_threads(1)

CPU = torch.device("cpu")
CFG = ViTConfig(image_size=20, image_patch_size=5, frames=20,
                frame_patch_size=5, num_classes=8, dim=64, depth=2, heads=4,
                dim_head=16, mlp_dim=128)


def _vit(seed=1, cfg=CFG):
    vit = ViT3D(cfg)
    vit.reset_parameters(torch.Generator().manual_seed(seed))
    return vit


def _t(g, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=g) * scale).to(dtype)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,model", [(2, 2), (4, 2), (8, 2), (8, 4)])
def test_mesh_rank_layout_and_subgroups(monkeypatch, world, model):
    """Rank r of a training mesh sits at data index r // model and model
    index r % model (JAX's reshape(data, model, pipe), model inner): its
    data group is the ranks of its model index, its model group the ranks
    of its data index; every rank makes every group in one order."""
    made = []
    monkeypatch.setattr(dist, "new_group",
                        lambda ranks: made.append(tuple(ranks)) or
                        tuple(ranks))
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    monkeypatch.setattr(distributed, "group", lambda: "world")
    data = world // model
    for r in range(world):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        made.clear()
        m = create_mesh({"MESH_MODEL_AXIS": model})
        assert m.shape == {DATA_AXIS: data, MODEL_AXIS: model, PIPE_AXIS: 1}
        assert (m.rank, m.model_index) == (r // model, r % model)
        assert m.group == tuple(range(r % model, world, model))
        assert m.model_group == tuple(range(r // model * model,
                                            (r // model + 1) * model))
        assert len(made) == data + model and m.distributed


def test_serving_mesh_groups_consecutive_cards_into_replicas():
    """A serving mesh of 8 devices at MESH_MODEL_AXIS 2 is 4 x 2; the
    Predictor on it holds 4 replicas, replica i on devices 2 i and 2 i + 1
    (the one-H100 layout repeats a card); no group within one process."""
    m = create_mesh({"MESH_MODEL_AXIS": 2}, [CPU] * 8)
    assert m.shape == {DATA_AXIS: 4, MODEL_AXIS: 2, PIPE_AXIS: 1}
    assert m.devices == (CPU,) * 8 and m.model_group is None
    config = dict(jax_load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "MODEL_VIT_DIM": 32, "MODEL_VIT_DEPTH": 1,
        "MODEL_VIT_HEADS": 2, "MODEL_VIT_DIM_HEAD": 16,
        "MODEL_VIT_MLP_DIM": 64}))
    p = Predictor(NeuroEncoder(config, device="cpu"), batch_size=8,
                  devices=m.devices, model_axis=m.model)
    assert len(p.replicas) == 4 and p.devices == (CPU,) * 4
    for replica in p.replicas:
        vit = replica.volume_encoder.vit3d
        assert vit.devices == [CPU, CPU] and vit.cfg.heads == 2


@pytest.mark.parametrize("extra,error,match", [
    ({"MESH_PIPE_AXIS": 2}, NotImplementedError,
     "pipeline parallelism.*Queue 1: multi-GPU"),
    ({"MESH_MODEL_AXIS": 2, "MESH_PIPE_AXIS": 2}, NotImplementedError,
     "pipeline parallelism.*Queue 1: multi-GPU"),
    ({"MESH_MODEL_AXIS": 3}, ValueError,
     "MESH_MODEL_AXIS=3 x MESH_PIPE_AXIS=1 does not divide 8 devices"),
    ({"MESH_DATA_AXIS": 3, "MESH_MODEL_AXIS": 2}, ValueError,
     "mesh 3x2x1 != 8 devices"),
])
def test_mesh_errors(extra, error, match):
    """The pipe axis still raises not_ported; the model axis takes JAX's
    errors."""
    with pytest.raises(error, match=match):
        create_mesh(extra, [CPU] * 8)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp_size", [2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_cut_and_join_round_trip(tp_size, quant):
    """Shard m of tp is a ViT of H / tp heads and mlp / tp hidden columns;
    joining the shards gives the whole state dict bit for bit; whole
    tensors are whole on every shard."""
    vit = _vit()
    if quant:
        quantize_blocks(vit)
    shards = [tp.cut_vit(vit, m, tp_size) for m in range(tp_size)]
    assert shards[0].cfg.heads == CFG.heads // tp_size
    assert shards[0].cfg.mlp_dim == CFG.mlp_dim // tp_size
    assert shards[0].quantized == quant
    whole = tp.join_states([s.state_dict() for s in shards])
    for key, value in vit.state_dict().items():
        assert torch.equal(whole[key], value), key
        if tp.rule(key) is None:
            assert all(torch.equal(s.state_dict()[key], value)
                       for s in shards), key


def test_rules_of_the_keys():
    """q, k and v by heads; fc1 and its bias by columns; Wout and W2 by
    their input columns; biases of row-parallel products, LN affines,
    the embedding and the head whole. The model group sums the LN
    affines' and the row-parallel biases' gradients."""
    p = "volume_encoder.vit3d.transformer.layers.3."
    assert tp.rule(p + "0.to_qkv.weight") == "heads"
    assert tp.rule(p + "0.qkv_scale") == "heads"
    assert tp.rule(p + "1.net.1.bias") == "col"
    assert tp.rule(p + "1.fc1_bias") == "col"
    assert tp.rule(p + "0.to_out.0.weight") == "row"
    assert tp.rule(p + "1.fc2_w8") == "row"
    for whole in ("0.to_out.0.bias", "1.net.4.bias", "0.norm.weight",
                  "1.fc2_scale", "0.out_scale"):
        assert tp.rule(p + whole) is None, whole
    assert tp.rule("volume_encoder.vit3d.pos_embedding") is None
    names = [p + n for n in ("0.norm.weight", "0.norm.bias",
                             "0.to_out.0.bias", "1.net.0.weight",
                             "1.net.0.bias", "1.net.4.bias",
                             "0.to_qkv.weight", "1.net.1.bias")]
    assert tp.partial_names(names) == names[:6]


@pytest.mark.parametrize("heads,mlp,tp_size,what", [
    (4, 128, 3, "heads"), (6, 100, 4, "heads"), (4, 102, 4, "mlp_dim"),
    (8, 100, 8, "mlp_dim")])
def test_indivisible_widths_are_refused(heads, mlp, tp_size, what):
    """A heads or mlp_dim count the model axis does not divide raises,
    naming the rule and ROADMAP.md, Queue 3."""
    cfg = ViTConfig(image_size=20, image_patch_size=5, frames=20,
                    frame_patch_size=5, num_classes=2, dim=64, depth=1,
                    heads=heads, dim_head=16, mlp_dim=mlp)
    with pytest.raises(ValueError, match=f"does not divide {what}.*"
                                         "ROADMAP.md, Queue 3"):
        tp.shard_config(cfg, tp_size)


def test_int8_cut_is_a_cut_of_the_whole_quantized_block():
    """A shard of an int8 ViT holds the whole block's codes and scales,
    cut (the row-parallel scales whole); quantizing a float shard alone
    would take each output column's amax over its own K only, and gives
    other row-parallel scales."""
    vit = _vit()
    q = quantize_blocks(copy.deepcopy(vit))
    want = tp.cut_state(q.state_dict(), 1, 2)
    got = tp.cut_vit(q, 1, 2).state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    alone = quantize_blocks(tp.cut_vit(vit, 1, 2)).state_dict()
    key = "transformer.layers.0.1.fc2_scale"
    assert not torch.equal(alone[key], got[key])
    key = "transformer.layers.0.0.qkv_scale"
    assert torch.equal(alone[key], got[key])       # column-parallel: same


# ---------------------------------------------------------------------------
# The forms' plain versions: the shards' partials against the whole
# ---------------------------------------------------------------------------

def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                                   atol=1e-6)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=1e-5)


def _block(dtype, tp_size, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, n, dim, inner, hid = 2, 9, 32, 32, 64
    ops = {"x": _t(g, b, n, dim, dtype=dtype),
           "attn": _t(g, b, n, inner, dtype=dtype),
           "ln": (_t(g, dim, scale=0.1) + 1, _t(g, dim, scale=0.1)),
           "wout": _t(g, dim, inner, scale=0.2), "bout": _t(g, dim),
           "w1": _t(g, hid, dim, scale=0.2), "b1": _t(g, hid),
           "w2": _t(g, dim, hid, scale=0.2), "b2": _t(g, dim),
           "wqkv": _t(g, 3 * inner, dim, scale=0.2),
           "dy": _t(g, b, n, dim, scale=0.1, dtype=dtype),
           "dqkv": _t(g, b, n, 3 * inner, scale=0.1, dtype=dtype)}
    part, hpart = inner // tp_size, hid // tp_size
    shards = []
    for m in range(tp_size):
        dq = ops["dqkv"].reshape(b, n, 3, inner)[..., m * part:(m + 1) * part]
        shards.append({
            "attn": ops["attn"][..., m * part:(m + 1) * part],
            "wout": tp.cut(ops["wout"], "row", m, tp_size),
            "w1": tp.cut(ops["w1"], "col", m, tp_size),
            "b1": tp.cut(ops["b1"], "col", m, tp_size),
            "w2": tp.cut(ops["w2"], "row", m, tp_size),
            "wqkv": tp.cut(ops["wqkv"], "heads", m, tp_size),
            "dqkv": dq.reshape(b, n, 3 * part), "hid": (m * hpart,
                                                        (m + 1) * hpart)})
    return ops, shards


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tp_size", [2, 4])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_outproj_partials_sum_to_the_whole(dtype, tp_size, rate):
    """[m = 0] x + Drop(a_m W_m^T + [m = 0] b) summed over the shards in
    f32 and rounded once is the one-process out-projection: one mask, one
    key, at the whole output's positions."""
    ops, shards = _block(dtype, tp_size)
    parts = [F.outproj_partial(ops["x"], s["attn"], s["wout"], ops["bout"],
                               first=m == 0, dropout_rate=rate, seed=7)
             for m, s in enumerate(shards)]
    assert all(p.dtype == torch.float32 for p in parts)
    want = fused_outproj.fused_outproj_residual(
        ops["x"], ops["attn"], ops["wout"], ops["bout"], dropout_rate=rate,
        seed=7)
    _close(torch.stack(parts).sum(0).to(dtype), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tp_size", [2, 4])
def test_mlp_partials_sum_to_the_whole(dtype, tp_size):
    """K4's form: the shards' f32 partials (rank 0's with b2 and x)
    summed and rounded once are the one-process MLP block; each shard's h
    is the whole h's columns."""
    ops, shards = _block(dtype, tp_size)
    args = (ops["x"], *ops["ln"])
    parts, hs = [], []
    for m, s in enumerate(shards):
        y, h = F.mlp_partial(*args, s["w1"], s["b1"], s["w2"], ops["b2"],
                             first=m == 0, return_h=True)
        parts.append(y)
        hs.append(h)
    want, h_all = fused_mlp.fused_mlp_block_plain(
        *args, ops["w1"], ops["b1"], ops["w2"], ops["b2"], return_h=True)
    _close(torch.stack(parts).sum(0).to(dtype), want, dtype)
    assert torch.equal(torch.cat(hs, dim=-1), h_all)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tp_size", [2, 4])
def test_ln_backward_of_summed_partials_is_the_whole(dtype, tp_size):
    """K7's and K9's forms: the LayerNorm backward is linear in du, so the
    shards' f32 partial dx (K9's first shard with dy) summed and rounded
    once is the whole backward's dx; dgamma and dbeta sum likewise."""
    ops, shards = _block(dtype, tp_size)
    x, ln, dy = ops["x"], ops["ln"], ops["dy"]
    _, h_all = fused_mlp.fused_mlp_block_plain(
        x, *ln, ops["w1"], ops["b1"], ops["w2"], ops["b2"], return_h=True)
    outs = [F.mlp_bwd_partial(dy, x, h_all[..., slice(*s["hid"])], *ln,
                              s["w1"], s["w2"], first=m == 0)
            for m, s in enumerate(shards)]
    want = fused_mlp.fused_mlp_bwd_plain(dy, x, h_all, *ln, ops["w1"],
                                         ops["w2"])
    assert all(o[0].dtype == torch.float32 for o in outs)
    _close(sum(o[0] for o in outs).to(dtype), want[0], dtype)
    _close(sum(o[5] for o in outs), want[5], torch.float32)
    _close(sum(o[6] for o in outs), want[6], torch.float32)
    outs = [F.ln_qkv_bwd_partial(s["dqkv"], x, ln[0], s["wqkv"])
            for s in shards]
    want = fused_qkv.fused_ln_qkv_bwd_plain(ops["dqkv"], x, ln[0],
                                            ops["wqkv"])
    _close(sum(o[0] for o in outs).to(dtype), want[0], dtype)
    _close(sum(o[1] for o in outs), want[1], torch.float32)
    _close(sum(o[2] for o in outs), want[2], torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tp_size", [2, 4])
def test_split_row_quantize_gives_the_one_shot_codes(dtype, tp_size):
    """K11's and K12's split: each shard's row amax, maxed over the model
    group, gives the one-shot codes of the whole row bit for bit; the
    shards' int32 accumulators, summed and run through the epilogue once,
    give the one-card int8 passes bit for bit."""
    ops, shards = _block(dtype, tp_size)
    x, ln = ops["x"], ops["ln"]
    a = ops["attn"]
    amax = torch.stack([F.int8_row_amax(s["attn"]) for s in shards]).amax(0)
    codes = torch.cat([F._codes(s["attn"].float(), amax)[0] for s in shards],
                      dim=-1)
    want_codes, want_scale = q8._rowquant(a.float())
    assert torch.equal(codes, want_codes)
    assert torch.equal(F._codes(a.float(), amax)[1], want_scale)
    w8, s8 = q8.quantize_weight(ops["wout"])
    parts = [F.int8_outproj_partial(s["attn"], amax,
                                    tp.cut(w8, "row", m, tp_size))
             for m, s in enumerate(shards)]
    assert all(p.dtype == torch.int32 for p in parts)
    acc = torch.stack(parts).sum(0, dtype=torch.int32)
    got = F.int8_dequant_residual(x, acc, amax, s8, ops["bout"])
    want = q8.int8_outproj_residual_plain(x, a, w8, s8, ops["bout"])
    assert got.dtype == dtype and torch.equal(got, want)
    (w18, s18), (w28, s28) = (q8.quantize_weight(ops["w1"]),
                              q8.quantize_weight(ops["w2"]))
    hidden = [F.int8_mlp_hidden(x, *ln, tp.cut(w18, "col", m, tp_size),
                                tp.cut(s18, "col", m, tp_size),
                                tp.cut(ops["b1"], "col", m, tp_size))
              for m in range(tp_size)]
    gmax = torch.stack([h[1] for h in hidden]).amax(0)
    g_all = torch.cat([h[0] for h in hidden], dim=-1)
    assert torch.equal(F._codes(g_all, gmax)[0],
                       q8._rowquant(g_all)[0])
    parts = [F.int8_mlp_partial(state, gmax, tp.cut(w28, "row", m, tp_size))
             for m, (state, _) in enumerate(hidden)]
    acc = torch.stack(parts).sum(0, dtype=torch.int32)
    got = F.int8_dequant_residual(x, acc, gmax, s28, ops["b2"])
    want = q8.int8_mlp_block_plain(x, *ln, w18, s18, ops["b1"], w28, s28,
                                   ops["b2"])
    assert torch.equal(got, want)


def test_column_site_keys_differ_by_model_index_row_sites_do_not():
    """The column-parallel sites' keys fold in the model index: no two
    shards draw one mask, and each keeps the keep rate; a row-parallel
    site's key is the one-process key on every shard."""
    key = nn.site_seed(123456789, 1)
    keys = [tp.column_seed(key, m) for m in range(4)]
    assert len(set(keys + [key])) == 5
    masks = [nn.keep_mask(k, (8, 126, 2, 16), 0.1) for k in keys]
    for m in masks:
        assert abs(float(m.float().mean()) - 230 / 256) < 0.01
    assert all(not torch.equal(m, masks[0]) for m in masks[1:])


def test_sharded_loader_pads_the_global_batch():
    """A global batch of 5 over a data axis of 2: each data index loads 3
    rows, rows r, r + 2, ... of the batch padded to 6 as JAX pads it (the
    pad row repeats the last volume, label 0, valid False); the epoch's
    short last batch pads its own tail the same way."""

    class Ids:
        def __len__(self):
            return 12

        def sample(self, idx):
            return {"volume": np.full((1,), idx, np.float32),
                    "label": idx + 1}

    whole = list(DataLoader(Ids(), 5, shuffle=True, seed=3, num_workers=1))
    parts = [list(DataLoader(Ids(), 3, shuffle=True, seed=3, num_workers=1,
                             shard=(r, 2), global_batch=5))
             for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 3
    for k, batch in enumerate(whole):
        m = create_mesh({}, [CPU, CPU])
        for r in range(2):
            want = sharding.local_rows(batch, mesh.Mesh(m.shape, rank=r))
            got = parts[r][k]
            assert got["valid"].tolist() == want["valid"].tolist()
            assert got["volume"].ravel().tolist() == \
                want["volume"].ravel().tolist()
            assert got["label"][got["valid"]].tolist() == \
                want["label"][want["valid"]].tolist()
    assert parts[1][0]["label"][-1] == 0 and not parts[1][0]["valid"][-1]


# ---------------------------------------------------------------------------
# Serving on a model axis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny config (f32) and a checkpoint written by the JAX package."""
    tmp = tmp_path_factory.mktemp("torch_tp_serving")
    config = jax_load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "gradcam", "GRADCAM_CUBE_SIZE": 8,
        "TRAINING_PRECISION": "f32", "TRAINING_DROPOUT": 0.0,
        "MODEL_VIT_DIM": 64, "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4,
        "MODEL_VIT_DIM_HEAD": 16, "MODEL_VIT_MLP_DIM": 128,
        "KERNEL_IMPL": "xla", "MESH_MODEL_AXIS": 2})
    jmodel = JaxNeuroEncoder(config)
    params = jmodel.init(jax.random.key(9))["params"]
    ckpt = str(tmp / "model.state_dict.pkl")
    jax_state_dict.save(ckpt, jax_state_dict.to_state_dict(jmodel, params))
    return config, ckpt


def _vols(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 20, 20, 20)).astype(np.float32)


@pytest.mark.parametrize("precision,quant", [("f32", None), ("bf16", None),
                                             ("f32", "int8"),
                                             ("bf16", "int8")])
def test_tp_predictor_matches_one_replica_and_jax(served, precision, quant):
    """A dp 2 x tp 2 Predictor over four CPU copies against the port's one
    replica and the JAX Predictor on a dp 2 x tp 2 mesh of four virtual
    devices, the same checkpoint, 5 volumes (a bucket of 4 and one of 2):
    f32 logits at JAX's 2e-3, int8 probabilities at 1e-4 with labels
    equal, bf16 probabilities at 2e-2. int8 replicas sum their int32
    accumulators, so their logits are one replica's bit for bit."""
    config, ckpt = served
    config = dict(config, TRAINING_PRECISION=precision)
    vols = _vols(11, 5)
    jmesh = jax_create_mesh(config, devices=jax.devices()[:4])
    jlabels, want_jax = JaxPredictor.from_checkpoint(
        config, ckpt, batch_size=4, mesh=jmesh, quant=quant)(vols)
    tp_pred = Predictor.from_checkpoint(config, ckpt, batch_size=4,
                                        quant=quant, devices=[CPU] * 4,
                                        model_axis=2)
    one = Predictor.from_checkpoint(config, ckpt, batch_size=4, device="cpu",
                                    quant=quant)
    assert len(tp_pred.replicas) == 2 and tp_pred.bucket_sizes == (2, 4)
    enc = tp_pred.model.volume_encoder.vit3d
    assert isinstance(enc, tp.TensorParallelViT) and len(enc.shards) == 2
    assert enc.quantized == (quant == "int8")
    labels, got = tp_pred(vols)
    olabels, want = one(vols)
    x = torch.from_numpy(vols)
    with torch.no_grad():
        lg, lw = tp_pred.model(x), one.model(x)
    if quant:
        assert torch.equal(lg, lw)
    if precision == "bf16":
        np.testing.assert_allclose(got, want, atol=2e-2)
        np.testing.assert_allclose(got, want_jax, atol=2e-2)
        return
    if quant:
        for w, wl in ((want, olabels), (want_jax, jlabels)):
            np.testing.assert_allclose(got, w, atol=1e-4)
            np.testing.assert_array_equal(labels, wl)
        return
    np.testing.assert_allclose(lg.numpy(), lw.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want_jax, rtol=2e-3, atol=2e-3)


def test_tp_predictor_refusals(served):
    """A model axis that does not divide the devices, a batch the data
    axis does not divide, and the ResNet (no tensor-parallel rule) are
    refused."""
    config, _ = served
    model = NeuroEncoder(config, device="cpu")
    with pytest.raises(ValueError, match="MESH_MODEL_AXIS=2 does not divide "
                                         "3 devices"):
        Predictor(model, batch_size=4, devices=[CPU] * 3, model_axis=2)
    with pytest.raises(ValueError, match=r"batch_size 3 must divide over "
                                         r"the mesh data axis \(2\)"):
        Predictor(model, batch_size=3, devices=[CPU] * 4, model_axis=2)
    resnet = NeuroEncoder(dict(config, MODEL_VOLUME_ENCODER="resnet",
                               MODEL_RESNET_DEPTH=10, DATASET_NAME="adni"),
                          device="cpu")
    with pytest.raises(ValueError, match="ViT volume encoder only"):
        Predictor(resnet, batch_size=4, devices=[CPU] * 2, model_axis=2)


def test_serving_cli_mesh_takes_the_model_axis(served, capsys):
    """--mesh --device cpu builds one replica over MESH_MODEL_AXIS copies
    of the CPU; its probabilities are one replica's."""
    import argparse
    from neurovit_tpu_torch import serving

    config, ckpt = served
    parser = argparse.ArgumentParser()
    serving.add_serving_args(parser)
    parser.add_argument("--batch-size", type=int, default=None)
    args = parser.parse_args(["--mesh", "--device", "cpu", "--checkpoint",
                              ckpt, "--batch-size", "2"])
    p = serving.predictor_from_cli_args(parser, args, config)
    assert "Serving over mesh {'data': 1, 'model': 2, 'pipe': 1}" in \
        capsys.readouterr().out
    assert isinstance(p.model.volume_encoder.vit3d, tp.TensorParallelViT)
    vols = _vols(3, 2)
    _, want = Predictor.from_checkpoint(config, ckpt, batch_size=2,
                                        device="cpu")(vols)
    np.testing.assert_allclose(p(vols)[1], want, atol=1e-6)


def test_trainer_tensor_parallel_needs_its_processes(tmp_path):
    """MESH_MODEL_AXIS 2 in one process is JAX's error: the axis does not
    divide one device."""
    import torch_parallel_worker as worker
    from neurovit_tpu_torch.training import Trainer

    config = worker.tiny_config(str(tmp_path), MESH_MODEL_AXIS=2)
    with pytest.raises(ValueError, match="does not divide 1 devices"):
        Trainer(config, NeuroEncoder(config, device="cpu"),
                worker.Volumes(8), worker.Volumes(8))


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The dry run's entry point takes the card by default and refuses to
    run without one; device="cpu" (``--device cpu``) asks for the CPU. Its
    ranks take the cards in turn."""
    from neurovit_tpu_torch import dryrun
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["2"])
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device=None: calls.append((n, device)))
    dryrun.main(["4", "--device", "cpu"])
    dryrun.main([])
    assert calls == [(4, "cpu"), (4, "cuda")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dryrun._devices(torch.device("cuda"), 3) == [
        torch.device("cuda", 0), torch.device("cuda", 1),
        torch.device("cuda", 0)]
    assert dryrun._devices(torch.device("cpu"), 2) == [torch.device("cpu")] * 2
