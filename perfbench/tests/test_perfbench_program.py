"""The readers of the engine's own spans and tick records
(``engine.prefill_chunk_ms.serve``, ``engine.decode_ms.serve``,
``engine.host_ms.serve``) over a whole tiny chat run on the CPU, where a
device span's time is its host time: the program's records cover the
window's ticks one for one, each reader reads a finite number, the three
and the other two spans add back up to the engine's mean tick, and a
program without the records (or a run whose window they miss) reads
nothing."""
import collections
import dataclasses
import math

import pytest

import tiny
from perfbench import bench, program
from repro_torch.obs import telemetry

READERS = ("engine.prefill_chunk_ms.serve", "engine.decode_ms.serve",
           "engine.host_ms.serve")


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    # the tiny cell's clients are done early in the window, and its empty
    # ticks (tens of microseconds on the CPU) outrun the records the
    # program keeps: keep them all for this run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(telemetry, "RECENT_TICKS", collections.deque())
        cell, rec, _ = tiny.run(root, seconds=1.0)
        yield root, cell, rec


def test_span_readers_add_up_to_the_tick(ran):
    root, cell, rec = ran
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    got = {m: bench.reader(root, m)(rec) for m in READERS}
    assert all(v is not None and math.isfinite(v) and v > 0
               for v in got.values()), got
    ticks = program.window_ticks(rec)
    assert len(ticks) == len(rec.ticks)
    # each record ended inside its harness tick: after the one before it
    # returned, before its own return
    ends = [rec.t_open] + [t.t1 for t in rec.ticks]
    assert all(a < r.t <= b for a, r, b in zip(ends, ticks, ends[1:]))
    assert sum(t.chunks for t in ticks) > 0

    def dev(span):
        return sum(t.device_s.get(span, 0.0) for t in ticks)

    decodes = sum("decode_tick/device" in t.device_s for t in ticks)
    parts = (got["engine.prefill_chunk_ms.serve"]
             * sum(t.chunks for t in ticks)
             + got["engine.decode_ms.serve"] * decodes
             + 1e3 * dev("admit") + 1e3 * dev("prompt_sample"))
    mean_tick_ms = 1e3 * sum(t.wall_s for t in ticks) / len(ticks)
    assert mean_tick_ms * 1e-3 * len(ticks) <= rec.window_s
    assert parts / len(ticks) + got["engine.host_ms.serve"] == pytest.approx(
        mean_tick_ms, rel=0, abs=1e-9)


def test_span_readers_read_nothing_without_the_records(ran, monkeypatch):
    root, _, rec = ran
    # a window the records miss: none of its ticks, or one tick short
    for run in (dataclasses.replace(rec, t_open=rec.t_close),
                dataclasses.replace(rec, ticks=rec.ticks + rec.ticks[:1])):
        assert [bench.reader(root, m)(run) for m in READERS] == [None] * 3
    # a program that keeps no tick records
    monkeypatch.delattr(telemetry, "RECENT_TICKS")
    assert [bench.reader(root, m)(rec) for m in READERS] == [None] * 3
