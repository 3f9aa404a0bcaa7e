"""`ecnf_tpu_torch.parallel`'s start-up and helpers in a single process
(the counterpart of `tests/test_multihost.py`'s unit tests): the process
group starts only under a coordinator, explicit arguments win over the
environment, a second call does nothing, the card is not touched before
the group is asked for, and with no group the mesh is None and every
helper is the identity.  The multi-rank behaviour is in
`test_torch_sharded_divergence.py`, `test_torch_ddp_train.py` and
`test_torch_parallel_programs.py`."""
import pytest
import torch
import torch.distributed as dist

from ecnf_tpu_torch.parallel import distributed as pdist
from ecnf_tpu_torch.parallel import mesh as pmesh


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def calls(monkeypatch):
    """Record `init_process_group` instead of starting a group; any CUDA
    initialisation raises."""
    recorded = []

    def boom(*a, **k):
        raise AssertionError("maybe_initialize_distributed touched CUDA")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: recorded.append(kw))
    monkeypatch.setattr(torch.cuda, "init", boom)
    monkeypatch.setattr(torch.cuda, "_lazy_init", boom)
    return recorded


def test_noop_without_coordinator(calls):
    assert pdist.maybe_initialize_distributed() is False
    assert calls == []


def test_env_vars_resolve_args(calls, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:9")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    assert pdist.maybe_initialize_distributed() is True
    assert calls == [dict(init_method="tcp://10.0.0.1:9", world_size=4, rank=3, backend="gloo")]


def test_explicit_args_win_over_env(calls, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:9")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    assert pdist.maybe_initialize_distributed(
        coordinator_address="file:///tmp/store", num_processes=2, process_id=1
    ) is True
    assert calls == [dict(init_method="file:///tmp/store", world_size=2, rank=1, backend="gloo")]


def test_coordinator_without_count_or_id_raises(calls, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:9")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        pdist.maybe_initialize_distributed()
    assert calls == []


def test_second_call_is_a_noop(calls, monkeypatch):
    assert pdist.maybe_initialize_distributed("127.0.0.1:1234", 1, 0) is True
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: pytest.fail("re-initialized an initialized process"))
    assert pdist.maybe_initialize_distributed("127.0.0.1:1234", 1, 0) is False
    assert len(calls) == 1


def test_card_is_chosen_before_the_group(calls, monkeypatch):
    """On a card: ``set_device`` of ``local_device_ids``' card, then NCCL
    bound to it, and CUDA not initialised by the call itself."""
    order = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: order.append(("set_device", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: order.append(("init", kw["backend"], kw["device_id"])))
    assert pdist.maybe_initialize_distributed("127.0.0.1:1234", 2, 1, local_device_ids=[3])
    card = torch.device("cuda", 3)
    assert order == [("set_device", card), ("init", "nccl", card)]
    with pytest.raises(ValueError, match="one card"):
        pdist.maybe_initialize_distributed("127.0.0.1:1234", 2, 1, local_device_ids=[0, 1])


def test_pad_to_multiple():
    assert [pmesh.pad_to_multiple(b, 4) for b in (1, 4, 5, 8, 9)] == [4, 4, 8, 8, 12]
    assert pmesh.pad_to_multiple(9, 1) == 9


def test_process_batch_slice(monkeypatch):
    assert pdist.process_batch_slice(12) == slice(0, 12)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert pdist.process_batch_slice(12) == slice(6, 12)


def test_get_mesh_2d_checks_the_world():
    assert pmesh.get_mesh_2d(1) is None
    assert pmesh.get_mesh_2d(1, 1) is None
    with pytest.raises(ValueError, match=r"\(2, 1, 1\)"):
        pmesh.get_mesh_2d(2, 1)
    with pytest.raises(ValueError, match="every rank"):
        pmesh.get_mesh(devices=[0, 1])


def test_single_process_has_no_mesh_and_no_collective(monkeypatch):
    for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, lambda *a, **k: pytest.fail("a collective ran"))
    mesh = pmesh.get_mesh()
    assert mesh is None and pmesh.axis_size(mesh) == 1 and pmesh.axis_rank(mesh) == 0
    x = torch.arange(6.0).reshape(3, 2)
    tree = {"x": x, "rest": (x, None)}
    sharded = pmesh.shard_batch(tree, mesh)
    assert sharded["x"] is x and sharded["rest"][0] is x and sharded["rest"][1] is None
    assert pmesh.replicate(tree, mesh) is tree
    assert pmesh.gather_rows(x, mesh) is x and pmesh.all_reduce_sum(x, mesh) is x
    assert pdist.is_main_process() and pdist.world() == (0, 1)
    pdist.barrier()
    assert isinstance(pmesh.replicated(mesh), pmesh.Replicate)
    assert pmesh.data_sharded(mesh) == pmesh.Shard(0)
