"""The port's CUDA-graph replay rule (geo4d_tpu_torch/ops/graphs.py) on the
CPU, through stand-in graphs: warm, capture, replay; one graph at a time;
inputs copied before each replay; the eager switch; the kernels' launch
counts charged to each replay; and the aligner's graph path against its
eager run. The training step's graph path is tested in
tests/test_torch_training.py with the same stand-in."""

import contextlib

import numpy as np
import pytest
import torch

from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
from geo4d_tpu_torch.core.timing import SpanRecorder, recording
from geo4d_tpu_torch.ops import graphs
from geo4d_tpu_torch.tools.profile_aligner import synthetic_scene

torch.set_num_threads(1)


class StandInGraph:
    """A CUDA graph's part on the CPU: the capture runs `fn` once (its
    launches are noted as the wrappers note them while capturing); a replay
    returns the captured output."""

    def __init__(self, device, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        return self.out


class ReplayingGraph(StandInGraph):
    """A stand-in whose replay runs `fn` again, on the static inputs the
    replay copied in, so that a caller's graph path runs on the CPU."""

    built = []

    def __init__(self, device, fn):
        super().__init__(device, fn)
        ReplayingGraph.built.append(self)

    def replay(self):
        return self.fn()


def _stats():
    from geo4d_tpu_torch.ops import align_objective, flash_attention, group_norm, temporal_attention

    return (group_norm.stats, flash_attention.stats, temporal_attention.stats,
            align_objective.stats)


def _stats_snapshot():
    return [(s.launches, dict(s.by_shape), s.backward_launches, dict(s.backward_by_shape))
            for s in _stats()]


def test_graph_replay_rule(monkeypatch):
    """The first call of a key is eager, the next captures and replays, later
    ones replay; inputs reach the graph through its static clones; another
    key frees the graph and a key seen before captures at once; other
    `reads` capture anew; `release` runs before each capture, inside its
    span; under `eager()` every call is eager."""
    monkeypatch.setattr(graphs, "_graph", lambda device: ReplayingGraph)
    ReplayingGraph.built = []
    events, seen = [], []

    def fn(x):
        seen.append(x)
        return x + 1

    replay = graphs.GraphReplay("cpu", "cap", release=lambda: events.append("release"))
    rec = SpanRecorder()

    def call(key, value, reads=()):
        x = torch.tensor([value])
        out, replayed = replay(key, fn, [x], reads)
        assert float(out) == value + 1
        return replayed, seen[-1] is x

    with recording(rec):
        assert call("a", 1.0) == (False, True)          # eager, on the caller's tensor
        assert call("a", 5.0) == (True, False)          # capture, replay on the clone
        assert call("a", 7.0) == (True, False)
        assert len(ReplayingGraph.built) == 1
        assert call("b", 2.0) == (False, True)          # a new key: eager, graph freed
        assert replay.graph is None
        assert call("a", 3.0) == (True, False)          # warm: captures at once
        assert len(ReplayingGraph.built) == 2
        t, u = torch.zeros(1), torch.zeros(1)
        assert call("a", 4.0, [t]) == (True, False)     # other reads: captured anew
        assert call("a", 6.0, [t]) == (True, False)
        assert len(ReplayingGraph.built) == 3
        assert call("a", 8.0, [u]) == (True, False)
        assert len(ReplayingGraph.built) == 4 and replay.reads[0] is u
        with graphs.eager():
            assert call("a", 9.0, [u]) == (False, True)
            assert replay.graph is None
            assert call("c", 1.0) == (False, True)
            assert call("c", 2.0) == (False, True)
        assert len(ReplayingGraph.built) == 4
    assert events == ["release"] * 4
    caps = [s for s in rec.spans if s.name == "cap"]
    assert len(caps) == 4 and all(s.parent is None for s in caps)


def test_step_graph_charges_captured_launches_to_each_replay(monkeypatch):
    """A capture leaves every kernel's launch counts as they were (a captured
    launch runs nothing); each replay adds exactly what the capture noted,
    forward and backward, per shape, the aligner's objective kernel
    included."""
    from geo4d_tpu_torch.ops import align_objective, flash_attention, group_norm, temporal_attention

    monkeypatch.setattr(graphs, "_graph", lambda device: StandInGraph)
    group_norm.stats.note_launch((1, 64, 32, True))       # counts from before the capture

    def fn():
        group_norm.stats.note_launch((1, 64, 32, True))
        group_norm.stats.note_launch((2, 16, 64, False))
        group_norm.stats.note_backward((1, 64, 32, True))
        flash_attention.stats.note_launch((1, 256, 256, 5))
        flash_attention.stats.note_backward((1, 256, 256, 5))
        temporal_attention.stats.note_backward((64, 16, 320, 5))
        align_objective.stats.note_launch((7, 192, 3, True))
        return "out"

    replay = graphs.GraphReplay("cpu", "capture")
    assert replay("key", fn) == ("out", False)             # eager: the wrappers' own notes
    before = _stats_snapshot()
    for n in (1, 2):
        assert replay("key", fn) == ("out", True)           # the first also captures
        gn, fa, ta, ao = _stats_snapshot()
        b_gn, b_fa, b_ta, b_ao = before
        assert gn[0] == b_gn[0] + 2 * n and gn[2] == b_gn[2] + n
        assert gn[1] == {(1, 64, 32, True): b_gn[1][(1, 64, 32, True)] + n,
                         (2, 16, 64, False): b_gn[1].get((2, 16, 64, False), 0) + n,
                         **{k: v for k, v in b_gn[1].items()
                            if k not in ((1, 64, 32, True), (2, 16, 64, False))}}
        assert gn[3][(1, 64, 32, True)] == b_gn[3].get((1, 64, 32, True), 0) + n
        assert fa[0] == b_fa[0] + n and fa[2] == b_fa[2] + n
        assert fa[3][(1, 256, 256, 5)] == b_fa[3].get((1, 256, 256, 5), 0) + n
        assert ta[0] == b_ta[0] and ta[1] == b_ta[1] and ta[2] == b_ta[2] + n
        assert ao[0] == b_ao[0] + n and ao[2] == b_ao[2]
        assert ao[1][(7, 192, 3, True)] == b_ao[1].get((7, 192, 3, True), 0) + n


def test_step_graph_restores_counts_when_capture_fails(monkeypatch):
    from geo4d_tpu_torch.ops import group_norm

    monkeypatch.setattr(graphs, "_graph", lambda device: StandInGraph)
    calls = []

    def fn():
        calls.append(len(calls))
        group_norm.stats.note_launch((3, 8, 8, False))
        if len(calls) == 2:
            raise RuntimeError("capture failed")

    replay = graphs.GraphReplay("cpu", "capture")
    replay("key", fn)
    before = _stats_snapshot()
    with pytest.raises(RuntimeError, match="capture failed"):
        replay("key", fn)
    assert calls == [0, 1] and replay.graph is None
    assert _stats_snapshot() == before


def test_aligner_graph_path_replays_the_eager_run(monkeypatch):
    """GroupAligner.run's graph path (forced on the CPU, a stand-in graph
    that re-runs the capture) on a scene whose flow term switches on in
    phase 1: three loss structures, so three eager iterations and one
    capture each, made before its iteration's span; the rest replay; the
    final params and loss equal the eager run's bit for bit."""
    sc = synthetic_scene(n=7, h=12, w=16, focal=20.0, window=4, stride=1)
    flows = np.random.default_rng(3).normal(0, 1, (6, 12, 16, 2)).astype(np.float32)
    cfg = AlignerConfig(n_iter=12, depth_traj_start_iter=6, flow_loss_weight=0.1,
                        flow_loss_start_frac=0.25)
    monkeypatch.setattr(graphs, "_graph", lambda device: ReplayingGraph)
    ReplayingGraph.built = []
    p = sc["preds"]
    runs = {}
    for name, mode in (("graph", contextlib.nullcontext), ("eager", graphs.eager)):
        al = GroupAligner(sc["groups"], p["pts3d"], p["conf"], sc["hw"], invdepth=p["inv_depth"],
                          trajs=p["traj"], config=cfg, target_flows=flows, device="cpu")
        rec = SpanRecorder()
        with mode(), recording(rec):
            al.run()
        runs[name] = al, rec
    (graph, graph_rec), (eager, eager_rec) = runs["graph"], runs["eager"]
    for k in eager.params:
        assert torch.equal(graph.params[k], eager.params[k]), k
    assert graph.final_loss == eager.final_loss
    assert graph_rec.totals() == {"align_eager_iters": 3, "align_graph_replays": 9}
    assert eager_rec.totals() == {"align_eager_iters": 12}
    names = {s.id: s.name for s in graph_rec.spans}
    assert [names[s.parent] for s in graph_rec.spans if s.name == "align_capture"] == [
        "align_phase1", "align_phase1", "align_phase2"]
    assert not any(s.name == "align_capture" for s in eager_rec.spans)
    assert len(ReplayingGraph.built) == 3
