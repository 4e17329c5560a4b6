"""The port's ``parallel`` package in one process: the mesh and its
errors (as ``tests/test_sharding.py:15-24``), the process group's start,
the rows and gathers of a one-rank group, the ranks' dropout seeds, and
``Predictor(devices=[...])`` against one replica and against the JAX
Predictor on a mesh of 2 virtual devices.

Tolerances: two CPU replicas give the one-replica probabilities within
1e-6 absolute, the bound ``tests/test_torch_serving.py`` holds a bucket's
rows to single calls to (the plain path's products are summed in other
blocks for another number of rows); against the JAX mesh Predictor,
the port's serving bound (``tests/test_torch_serving.py``), 1e-4 abs +
1e-4 rel at f32.
"""

import os
import socket
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from neurovit_tpu.config import load_config
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.parallel import create_mesh as jax_create_mesh
from neurovit_tpu.serving import Predictor as JaxPredictor
from neurovit_tpu.training import state_dict as jax_state_dict
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                         Mesh, create_mesh, current_mesh,
                                         distributed, sharding, use_mesh)
from neurovit_tpu_torch.serving import Predictor

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_mesh_shapes_and_errors():
    """JAX's rule over 8 devices; its errors; a pipe axis above 1 raises
    not_ported naming multi-GPU and what it is, with a model axis too (the
    model axis alone builds: tests/test_torch_tensor_parallel.py)."""
    mesh = create_mesh({"MESH_DATA_AXIS": -1, "MESH_MODEL_AXIS": 1},
                       [CPU] * 8)
    assert mesh.shape == {DATA_AXIS: 8, MODEL_AXIS: 1, PIPE_AXIS: 1}
    assert mesh.data == 8 and len(mesh.devices) == 8
    assert create_mesh({"MESH_DATA_AXIS": 8}, [CPU] * 8).data == 8
    assert create_mesh().shape == {DATA_AXIS: 1, MODEL_AXIS: 1, PIPE_AXIS: 1}
    with pytest.raises(ValueError, match="mesh 5x1x1 != 8 devices"):
        create_mesh({"MESH_DATA_AXIS": 5}, [CPU] * 8)
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 devices"):
        create_mesh({"MESH_DATA_AXIS": 2})
    with pytest.raises(ValueError, match="runs 4 processes"):
        create_mesh({}, 4)                       # no group of 4 here
    with pytest.raises(NotImplementedError,
                       match="pipeline parallelism.*Queue 1: multi-GPU"):
        create_mesh({"MESH_DATA_AXIS": -1, "MESH_MODEL_AXIS": 2,
                     "MESH_PIPE_AXIS": 2}, [CPU] * 8)
    with pytest.raises(NotImplementedError,
                       match="pipeline parallelism.*Queue 1: multi-GPU"):
        create_mesh({"MESH_PIPE_AXIS": 2}, [CPU] * 8)


def test_no_group_is_a_no_op(monkeypatch):
    """Without torchrun's variables or DISTRIBUTED_MULTIHOST nothing
    starts; the mesh is one process and the model sees no mesh."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not distributed.requested({})
    assert distributed.maybe_initialize({}, CPU) is False
    assert not dist.is_initialized()
    assert distributed.rank() == 0 and distributed.world_size() == 1
    mesh = create_mesh({})
    assert not mesh.distributed and mesh.group is None
    with use_mesh(mesh):
        assert current_mesh() is None


def test_failed_nccl_start_raises_and_never_tries_gloo(monkeypatch):
    """A CUDA device asks for NCCL; when its start fails the error is
    raised, and no gloo group is started in its place."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    backends = []

    def refuse(backend, **kwargs):
        backends.append(backend)
        raise RuntimeError("NCCL error: no card")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    with pytest.raises(RuntimeError, match="NCCL error"):
        distributed.maybe_initialize({}, torch.device("cuda", 0))
    assert backends == ["nccl"]
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_group(monkeypatch):
    """A one-rank gloo group started from the DISTRIBUTED_* keys (no
    torchrun variables), destroyed after the test."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    config = {"DISTRIBUTED_MULTIHOST": True,
              "DISTRIBUTED_COORDINATOR": f"localhost:{_free_port()}",
              "DISTRIBUTED_NUM_PROCESSES": 1, "DISTRIBUTED_PROCESS_ID": 0}
    assert distributed.maybe_initialize(config, CPU) is True
    try:
        yield config
    finally:
        distributed.shutdown()


def test_group_from_config_keys_is_adopted_and_a_mesh(one_rank_group):
    """The DISTRIBUTED_* keys start gloo on the CPU; a second call adopts
    the group; the mesh's data axis is the group, so collectives run."""
    assert dist.get_backend() == "gloo"
    assert distributed.maybe_initialize({}, CPU) is True     # adopted
    mesh = create_mesh(one_rank_group)
    assert mesh.distributed and mesh.data == 1 and mesh.rank == 0
    with use_mesh(mesh):
        assert current_mesh() is mesh
    alone = create_mesh({}, 1)
    assert alone.data == 1 and alone.distributed


def test_rows_pad_and_gather_in_order(one_rank_group):
    """pad_batch repeats the last volume with valid False; local_rows of a
    one-rank mesh is the whole padded batch; the gathers keep the order;
    the coalesced gradient reduction and broadcast are exact at world 1."""
    batch = {"volume": np.arange(5 * 2, dtype=np.float32).reshape(5, 2),
             "label": np.arange(5), "valid": np.ones(5, np.bool_),
             "subject": list("abcde")}
    padded = sharding.pad_batch(batch, 4)
    assert padded["volume"].shape == (8, 2)
    assert (padded["volume"][5:] == batch["volume"][-1]).all()
    assert padded["valid"].tolist() == [True] * 5 + [False] * 3
    assert padded["label"][5:].tolist() == [0, 0, 0]
    mesh = create_mesh({})
    rows = sharding.local_rows(batch, mesh)
    assert rows["subject"] == list("abcde") and len(rows["label"]) == 5
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(sharding.gather_rows(t, mesh), t)
    assert torch.equal(sharding.gather_stream(t, mesh), t)
    model = torch.nn.Linear(3, 2)
    before = [p.detach().clone() for p in model.parameters()]
    model(torch.ones(1, 3)).sum().backward()
    grads = [p.grad.clone() for p in model.parameters()]
    sharding.reduce_grads(model.parameters(), mesh)
    sharding.broadcast_module(model, mesh)
    assert all(torch.equal(p.grad, g)
               for p, g in zip(model.parameters(), grads))
    assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))


def test_strided_rows_are_the_unsharded_batch():
    """The loader's shard=(rank, world) at global batch B gives rank r the
    rows r, r + world, ... of the unsharded batch k: local_rows' layout."""
    from neurovit_tpu_torch.data.loader import DataLoader

    class Ids:
        def __len__(self):
            return 27

        def sample(self, idx):
            return {"volume": np.full((1,), idx, np.float32), "label": idx}

    world, b = 4, 8
    whole = list(DataLoader(Ids(), b, shuffle=True, seed=3, num_workers=1))
    parts = [list(DataLoader(Ids(), b // world, shuffle=True, seed=3,
                             num_workers=1, shard=(r, world)))
             for r in range(world)]
    assert all(len(p) == len(whole) for p in parts)
    for k, batch in enumerate(whole):
        for r in range(world):
            mesh = create_mesh({}, [CPU] * world)
            mesh = type(mesh)(mesh.shape, rank=r)
            want = sharding.local_rows(batch, mesh)
            got = parts[r][k]
            valid = want["valid"]
            assert got["valid"].tolist() == valid.tolist()
            assert (got["label"][valid] == want["label"][valid]).all()


def test_rank_seeds():
    """Rank 0 keeps the step seed (its masks are one process's); the other
    ranks' seeds differ from it and from each other, and so do masks."""
    seed = 123456789
    seeds = [sharding.rank_seed(seed, r) for r in range(8)]
    assert seeds[0] == seed
    assert len(set(seeds)) == 8
    assert all(0 <= s < 2 ** 63 for s in seeds)
    masks = [nn.keep_mask(nn.site_seed(s, 0), (64, 64), 0.1) for s in seeds]
    assert all(not torch.equal(m, masks[0]) for m in masks[1:])


# ---------------------------------------------------------------------------
# Predictor over devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny f32 config and a checkpoint written by the JAX package."""
    tmp = tmp_path_factory.mktemp("torch_parallel_serving")
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
    return config, ckpt


def _vols(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 20, 20, 20)).astype(np.float32)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_two_replicas_give_one_replica_rows(served, quant):
    """Two CPU replicas, each chunk split in two: every request size gives
    the one-replica probabilities, rows in input order; each int8 replica
    is quantized once, apart."""
    config, ckpt = served
    one = Predictor.from_checkpoint(config, ckpt, batch_size=4, device="cpu",
                                    quant=quant)
    two = Predictor.from_checkpoint(config, ckpt, batch_size=4, quant=quant,
                                    devices=["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.replicas[0] is two.model
    assert two.replicas[1] is not two.model
    assert two.bucket_sizes == (2, 4)            # 1 does not split in two
    if quant:
        for replica in two.replicas:
            assert replica.volume_encoder.vit3d.quantized
    for n in (1, 3, 9):
        vols = _vols(n, n)
        labels, probs = two(vols)
        _, want = one(vols)
        np.testing.assert_allclose(probs, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(labels, probs.argmax(axis=1))


def test_two_replicas_match_the_jax_mesh_predictor(served):
    """The JAX Predictor on a mesh of 2 virtual devices and the port's on
    two CPU replicas, the same checkpoint and batches."""
    config, ckpt = served
    vols = _vols(11, 5)
    mesh = jax_create_mesh(config, devices=jax.devices()[:2])
    _, want = JaxPredictor.from_checkpoint(config, ckpt, batch_size=4,
                                           mesh=mesh)(vols)
    _, got = Predictor.from_checkpoint(config, ckpt, batch_size=4,
                                       devices=["cpu", "cpu"])(vols)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_replica_count_must_divide_batch_and_buckets(served):
    """JAX's errors: a batch size the replicas do not divide raises;
    named buckets that do not divide are dropped with a warning, the
    default ones silently."""
    config, ckpt = served
    model = NeuroEncoder(config, device="cpu")
    with pytest.raises(ValueError, match=r"batch_size 3 must divide over "
                                         r"the mesh data axis \(2\)"):
        Predictor(model, batch_size=3, devices=["cpu", "cpu"])
    with pytest.warns(UserWarning, match=r"bucket_sizes \[1, 3\] dropped"):
        p = Predictor(model, batch_size=8, bucket_sizes=(1, 2, 3),
                      devices=["cpu", "cpu"])
    assert p.bucket_sizes == (2, 8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p = Predictor(model, batch_size=8, devices=["cpu", "cpu"])
    assert p.bucket_sizes == (2, 4, 8)


def test_trainer_at_world_one_is_the_one_device_step(one_rank_group,
                                                     tmp_path):
    """A one-rank group runs the data-parallel path (collectives included)
    and gives the one-device step bit for bit: loss, counts, parameters."""
    import torch_parallel_worker as worker
    from neurovit_tpu_torch.training import Trainer

    config = worker.tiny_config(str(tmp_path))
    batch = worker._tensors(worker.global_batches(1, n_valid=11)[0])
    out = []
    one_device = Mesh(create_mesh({}).shape)       # no group: no collective
    for mesh in (one_device, create_mesh({}, 1), create_mesh({})):
        model = NeuroEncoder(config, device="cpu", seed=1)
        trainer = Trainer(config, model, worker.Volumes(32),
                          worker.Volumes(32), logger=worker.ListLogger(),
                          mesh=mesh)
        m = trainer.train_step(batch)
        out.append((trainer.mesh.distributed, float(m["loss"]),
                    int(m["count"]), model.state_dict()))
    assert [o[0] for o in out] == [False, True, True]
    for dp, loss, count, state in out[1:]:
        assert loss == out[0][1] and count == out[0][2] == 11
        for key, value in state.items():
            assert torch.equal(value, out[0][3][key]), key


def test_main_under_torchrun_variables_refuses_a_missing_card(monkeypatch):
    """LOCAL_RANK names the card; one that is not there raises, and the
    CPU is never taken in its place."""
    from neurovit_tpu_torch import main

    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = main.parse_args([])
    with pytest.raises(RuntimeError, match="LOCAL_RANK 3 has no card"):
        main.resolve_device(args)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert main.resolve_device(args) == torch.device("cuda", 1)
    assert main.resolve_device(main.parse_args(["--device", "cpu"])) == CPU


def test_parallel_imports_neither_jax_nor_the_jax_package():
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "neurovit_tpu_torch", "parallel")
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            text = open(os.path.join(root, name)).read()
            assert "import jax" not in text and "neurovit_tpu." not in text \
                and "from neurovit_tpu " not in text, name
