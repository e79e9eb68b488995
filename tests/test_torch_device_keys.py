"""PyTorch port: per-device state is keyed by the card it lives on.

A rank of a mesh computes on its own card (``launch.init_process`` makes it
the current one). Every per-device object the port keeps (the launch
counters, the greedy pass's arrival counter, ``dist_chol``'s counters, the
cached constants, the body and capture streams) is keyed by
``control.card(device)``: a bare ``cuda`` names the current card with its
index, as the tensors made there report it. So ``cuda`` and ``cuda:<r>``
share one entry, and a rank never reaches another card's. These tests fake
the current card on the CPU (``torch.cuda.current_device`` and the objects
that would be made on the card), so they need none.

The same file holds the NCCL settings a rank needs to capture collectives
inside a conditional body at more than one rank (``mesh.NCCL_MIXING``).
"""

import os

import pytest
import torch

from cv_monoslam_tpu_torch.filter.state import resolve_device
from cv_monoslam_tpu_torch.ops import control, vision
from cv_monoslam_tpu_torch.parallel import dist_chol, launch, mesh

CURRENT = 2


@pytest.fixture
def card_two(monkeypatch):
    """Card 2 is current; CUDA is said to be available."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: CURRENT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_card_names_the_current_card(card_two):
    assert control.card("cuda") == torch.device("cuda", CURRENT)
    assert control.card(torch.device("cuda")) == torch.device("cuda",
                                                              CURRENT)
    assert control.card("cuda:1") == torch.device("cuda", 1)
    assert control.card("cpu") == torch.device("cpu")


def test_resolve_device_returns_the_indexed_card(card_two):
    assert resolve_device(None) == torch.device("cuda", CURRENT)
    assert resolve_device("cuda") == torch.device("cuda", CURRENT)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("get", [
    vision._counts, vision._greedy_arrivals, dist_chol._counts,
    lambda dev: control.constant((1.0, 2.0), torch.float32, dev)],
    ids=["launch_counts", "greedy_arrivals", "dist_chol_counts", "constant"])
def test_cached_keys_do_not_depend_on_the_index(card_two, monkeypatch, get):
    """The same entry for ``cuda`` and the current card's indexed name,
    another for another card."""
    monkeypatch.setattr(control, "cached", lambda key, build: key)
    bare, indexed, other = (get(d) for d in ("cuda", f"cuda:{CURRENT}",
                                             "cuda:0"))
    assert bare == indexed
    assert other != bare
    assert torch.device("cuda", CURRENT) in bare


def test_body_streams_are_one_per_card(card_two, monkeypatch):
    made = []

    class FakeStream:
        def __init__(self, device):
            made.append(device)

    monkeypatch.setattr(control, "_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    s = control._body_stream("cuda", 0)
    assert control._body_stream(f"cuda:{CURRENT}", 0) is s
    assert control.capture_stream("cuda") is control.capture_stream(
        torch.device("cuda", CURRENT))
    assert control._body_stream("cuda:0", 0) is not s
    assert made == [torch.device("cuda", CURRENT),
                    torch.device("cuda", CURRENT), torch.device("cuda", 0)]


def test_rank_takes_its_card_before_anything_names_one(monkeypatch, tmp_path):
    """``init_process`` makes rank r's card current before the group
    opens and never asks for the current card first: a rank that did
    would open a CUDA context on card 0 as well as on its own."""
    calls = []

    def current_device():
        calls.append("current_device")
        return CURRENT

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", current_device)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda dev: calls.append("set_device"))
    monkeypatch.setattr(launch.dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            (backend, kw["device_id"],
                             os.environ.get(mesh.NCCL_MIXING))))
    # unset, and restored after the test (init_process writes os.environ)
    monkeypatch.setenv(mesh.NCCL_MIXING, "")
    monkeypatch.delenv(mesh.NCCL_MIXING)
    dev = launch.init_process(CURRENT, 4, "cuda", str(tmp_path / "r"))
    assert dev == torch.device("cuda", CURRENT)
    # the group opens with NCCL's graph-mixing support off
    assert calls == ["set_device",
                     ("nccl", torch.device("cuda", CURRENT), "0")]


@pytest.fixture
def nccl_group(card_two, monkeypatch):
    """An initialized NCCL group of four ranks; this process is rank 2."""
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(mesh.dist, "get_rank", lambda *a: CURRENT)
    monkeypatch.setenv(mesh.NCCL_MIXING, "0")


def test_nccl_mesh_computes_on_its_rank_card(nccl_group):
    m = mesh.make_mesh()
    assert (m.device, m.rank, m.size, m.backend) == (
        torch.device("cuda", CURRENT), CURRENT, 4, "nccl")
    with pytest.raises(ValueError, match="its rank's card"):
        mesh.make_mesh(device="cuda:0")


@pytest.mark.parametrize("value", [None, "1"])
def test_nccl_mesh_needs_graph_mixing_off(nccl_group, monkeypatch, value):
    """With NCCL's graph-mixing support on, a collective captured in a
    conditional body fails to instantiate at more than one rank (four
    H100s, NCCL 2.28): the mesh refuses to start."""
    if value is None:
        monkeypatch.delenv(mesh.NCCL_MIXING)
    else:
        monkeypatch.setenv(mesh.NCCL_MIXING, value)
    with pytest.raises(ValueError, match=mesh.NCCL_MIXING):
        mesh.make_mesh()


def test_uncaptured_nccl_collectives_wait_for_the_card(monkeypatch):
    """NCCL with graph mixing off: an uncaptured collective of an NCCL
    mesh first waits until the card has finished (graph launches
    included); inside a capture, and on ``gloo``, nothing waits."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(("sync", dev)))
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    for name in ("all_reduce", "broadcast", "all_gather"):
        monkeypatch.setattr(mesh.dist, name,
                            lambda *a, _n=name, **kw: calls.append(_n))
    monkeypatch.setattr(mesh.dist, "get_global_rank", lambda g, r: r)
    card = torch.device("cuda", CURRENT)
    nccl = mesh.Mesh(group=None, rank=0, size=4, device=card,
                     backend="nccl")
    t = torch.zeros(2)
    nccl.all_reduce(t)
    nccl.broadcast(t, 0)
    nccl.all_gather(t)
    assert calls == [("sync", card), "all_reduce", ("sync", card),
                     "broadcast", ("sync", card), "all_gather"]
    calls.clear()
    capturing[0] = True
    nccl.all_reduce(t)
    capturing[0] = False
    mesh.Mesh(group=None, rank=0, size=4, device=card,
              backend="gloo").all_reduce(t)
    assert calls == ["all_reduce", "all_reduce"]
