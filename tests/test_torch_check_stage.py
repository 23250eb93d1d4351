"""chip_smoke.py's check stage: the plain versions held against a
kernel's result (`plain_check`) run after the timed readings, in processes
of their own, and their comparisons come back in the order they were made.

* `to_host` leaves no tensor in tuples, named tuples, lists and dicts,
  and `from_host` gives the same values, dtypes and shapes back.
* Without an open stage a check runs where it is made.
* With one, nothing runs until `run_check_stage`; then each plain version
  runs in a process (two at once here), its result equals the same call
  made in this process, the finishes run in the order the checks were
  made, `late` merges into the JSON line's entries by name, and the stage
  closes.
* A finish that raises ends the stage with its error, and the stage's
  processes end with it.
"""

import multiprocessing

import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace


def _cover_batch(width: int = 4):
    scene, cs = book_scenes.cover_scene()
    _, tables = chip_smoke.batch_inputs(scene, cs, width, width,
                                        torch.device("cpu"))
    n = width * width
    args = (torch.full((n,), 1, dtype=torch.int32), torch.zeros(n), *tables,
            11)
    kw = dict(samples=1, trace_depth=2,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True,
              want_tape=True)
    return args, kw


@pytest.fixture
def stage(monkeypatch):
    """An open stage of two processes, LATE emptied."""
    monkeypatch.setattr(chip_smoke, "PLAIN_WORKERS", 2)
    monkeypatch.setattr(chip_smoke, "LATE", [])
    monkeypatch.setattr(chip_smoke, "_PENDING", [])
    yield
    chip_smoke._PENDING = None


def test_host_round_trip():
    tex = megatrace.TexTables(torch.arange(6.0).reshape(2, 3), None,
                              torch.ones(2, 2, 3), (2, 2))
    x = (torch.tensor([1, -2], dtype=torch.int32), [torch.tensor([True])],
         {"k": torch.tensor([3], dtype=torch.int64), "s": "text"}, tex,
         (torch.full((2,), -0.0), 4), 7, None)
    host = chip_smoke.to_host(x)
    assert chip_smoke.tensor_device(host) is None
    back = chip_smoke.from_host(host, None)
    assert isinstance(back[3], megatrace.TexTables) and back[3][1] is None
    assert type(back[4]) is tuple and back[4][1] == 4
    assert back[2]["s"] == "text" and back[5:] == (7, None)
    for got, want in ((back[0], x[0]), (back[1][0], x[1][0]),
                      (back[2]["k"], x[2]["k"]), (back[3][0], tex[0]),
                      (back[3][2], tex[2]), (back[4][0], x[4][0])):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert torch.equal(torch.signbit(back[4][0]), torch.signbit(x[4][0]))


def test_check_runs_where_made_without_a_stage(monkeypatch):
    monkeypatch.setattr(chip_smoke, "_PENDING", None)
    seen = []
    chip_smoke.plain_check(torch.add, (torch.ones(2), 2.0), {},
                           lambda out, s: seen.append(out.tolist()))
    assert seen == [[3.0, 3.0]]


def test_stage_runs_checks_in_processes(stage):
    args, kw = _cover_batch()
    want = megatrace.sample_batch_reference(*args, **kw)
    order = []

    def finish(out, seconds):
        share, err = chip_smoke.lane_agreement(want, out)
        assert share == 1.0 and err == 0.0 and seconds > 0.0
        assert torch.equal(out["tape"], want["tape"])
        order.append("batch")
        chip_smoke.late("batch", "max_abs_err", 0.25)

    chip_smoke.plain_check(megatrace.sample_batch_reference, args, kw, finish)
    chip_smoke.plain_check(torch.mul, (torch.arange(3.0), 2.0), {},
                           lambda out, s: order.append(out.tolist()))
    assert order == []  # nothing runs before the stage
    chip_smoke.run_check_stage()
    assert order == ["batch", [0.0, 2.0, 4.0]]
    assert chip_smoke._PENDING is None
    entries = [{"name": "batch", "max_abs_err": 0.0}, {"name": "other"}]
    chip_smoke.apply_late(entries)
    assert entries == [{"name": "batch", "max_abs_err": 0.25},
                       {"name": "other"}]


def test_stage_raises_and_ends_its_processes(stage):
    def finish(out, seconds):
        raise RuntimeError("plain and kernel differ")

    chip_smoke.plain_check(torch.neg, (torch.ones(2),), {}, finish)
    with pytest.raises(RuntimeError, match="plain and kernel differ"):
        chip_smoke.run_check_stage()
    assert multiprocessing.active_children() == []
