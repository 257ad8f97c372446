"""The span recorder of `geo4d_tpu_torch.core.timing` on the CPU: span and
request ids, counters, other threads, the hooks without a recorder, and the
pipeline's spans at the tiny preset: `reconstruct` and one training step
hand a StageTimer the same stage calls as before the recorder existed,
with or without one installed."""

import threading
import time

import numpy as np
import pytest
import torch

from geo4d_tpu_torch.alignment.init import init_from_group
from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
from geo4d_tpu_torch.core import timing
from geo4d_tpu_torch.core.draws import Draws
from geo4d_tpu_torch.models.presets import init_random_, tiny
from geo4d_tpu_torch.pipeline.inference import InferenceConfig, reconstruct, sliding_windows
from geo4d_tpu_torch.training import step
from geo4d_tpu_torch.training.modalities import build_batch

torch.set_num_threads(1)
T, H, W, FRAMES, N_ITER = 4, 32, 64, 8, 10

# the stage calls a StageTimer received before the recorder was added
WINDOW = ["resampler", "ddim_step_0", "ddim_step_1", "decode", "postprocess"]
GOLDEN_RECONSTRUCT = (["clip", "vae_encode"] + WINDOW * 3
                      + ["align_init", "align_pnp", "align_init", "align_phase1", "calibrate",
                         "align_phase2"])
GOLDEN_HOST_INIT = (["align_init"] + ["align_pnp"] * 4) * 3 + ["align_init"]
GOLDEN_TRAIN_STEP = ["forward_backward", "optimizer"]


class LoggingTimer(timing.StageTimer):
    """A StageTimer that also lists every stage call, in order."""

    def __init__(self, device="cpu"):
        super().__init__(device)
        self.calls = []

    def __call__(self, name):
        self.calls.append(name)
        return super().__call__(name)


# ---------------- the recorder alone ----------------

def test_span_parents_requests_and_counters():
    rec = timing.SpanRecorder()
    with timing.recording(rec):
        timing.count("outside")
        with timing.request("first") as root:
            with timing.span("a") as a:
                timing.count("n", 2)
                with timing.request("nested") as nested:
                    timing.count("n")
            timing.count("m", 5)
        with timing.span("loose") as loose:
            with timing.request("second") as second:
                timing.count("n")
    assert [s.name for s in rec.spans] == ["first", "a", "nested", "loose", "second"]
    assert (root.parent, root.request) == (None, 0)
    assert (a.parent, a.request) == (root.id, 0)
    # a request inside a request is a plain span of it
    assert (nested.parent, nested.request) == (a.id, 0)
    assert (loose.parent, loose.request) == (None, None)
    assert (second.parent, second.request) == (loose.id, 1) and rec.requests == 2
    assert rec.counts == [(None, None, "outside", 1), (a.id, 0, "n", 2), (nested.id, 0, "n", 1),
                          (root.id, 0, "m", 5), (second.id, 1, "n", 1)]
    assert rec.totals() == {"outside": 1, "n": 4, "m": 5}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_other_threads_are_dropped():
    rec = timing.SpanRecorder()

    def work():
        with timing.span("worker"):
            timing.count("worker")
    with timing.recording(rec):
        with timing.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    assert [s.name for s in rec.spans] == ["main"] and rec.counts == []


def test_without_a_recorder_the_hooks_record_nothing():
    rec = timing.SpanRecorder()
    with timing.recording(rec):
        pass
    null = timing.span("x")
    assert timing.request("y") is null and timing.span("z") is null
    assert timing.stage(None, "w") is null
    with timing.span("a"), timing.request("b"), timing.stage(None, "c"):
        timing.count("d")
    assert rec.spans == [] and rec.counts == []


def test_stage_opens_its_span_inside_the_timer():
    stamps = []

    class Timer:
        def __call__(self, name):
            return self.Ctx(name)

        class Ctx:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                stamps.append(("enter", self.name, time.perf_counter_ns()))

            def __exit__(self, *exc):
                stamps.append(("exit", self.name, time.perf_counter_ns()))

    rec = timing.SpanRecorder()
    with timing.recording(rec):
        with timing.stage(Timer(), "stage_a"):
            with timing.span("inner"):
                pass
        with timing.stage(None, "stage_b"):
            pass
    assert [(k, n) for k, n, _ in stamps] == [("enter", "stage_a"), ("exit", "stage_a")]
    a, inner, b = rec.spans
    assert (a.name, inner.name, inner.parent, b.name) == ("stage_a", "inner", a.id, "stage_b")
    assert stamps[0][2] <= a.start_ns and a.end_ns <= stamps[1][2]


# ---------------- the pipeline's stages and spans ----------------

@pytest.fixture(scope="module")
def model():
    return init_random_(tiny(temporal_length=T, device="meta"), "cpu", seed=1).eval()


def _frames():
    return np.random.default_rng(1).integers(0, 256, size=(FRAMES, H, W, 3), dtype=np.uint8)


def _reconstruct(model, timer):
    return reconstruct(model, _frames(), np.zeros((1, 77, 64), np.float32), fps=24,
                       inference_config=InferenceConfig(window=T, stride=2, ddim_steps=2),
                       aligner_config=AlignerConfig(n_iter=N_ITER, depth_traj_start_iter=5),
                       timer=timer)


@pytest.fixture(scope="module")
def recorded_reconstruct(model):
    rec, timer = timing.SpanRecorder(), LoggingTimer()
    with timing.recording(rec):
        scene, _, _ = _reconstruct(model, timer)
    return rec, timer, scene


def _raw_clip():
    rng = np.random.default_rng(0)

    def maps(c=3):
        return torch.from_numpy(rng.uniform(-1, 1, size=(1, T, H, W, c)).astype(np.float32))
    return {"normed_allpts": maps(), "plucker_raymap": maps(), "plucker_cross": maps(),
            "inverse_depth": maps(1), "video": maps(), "fps": torch.tensor([24])}


def _train_step(model, timer):
    cfg = step.TrainConfig(learning_rate=1e-3, temporal_length=T)
    state = step.create_train_state(model.unet)
    fn = step.make_train_step(model.unet, model.schedule, cfg)
    prompt = torch.zeros(1, 77, 64)
    with timing.request("train_step"):
        batch = build_batch("pc_ray_cross_depth", model, _raw_clip(), Draws.seeded([0, 0], "cpu"),
                            prompt, prompt)
        fn(state, batch, Draws.seeded([0, 1], "cpu"), timer)


@pytest.mark.parametrize("recorder", [False, True])
def test_reconstruct_hands_the_timer_the_same_stages(model, recorded_reconstruct, recorder):
    if recorder:
        timer = recorded_reconstruct[1]
    else:
        timer = LoggingTimer()
        _reconstruct(model, timer)
    assert timer.calls == GOLDEN_RECONSTRUCT
    assert list(timer.seconds) == list(dict.fromkeys(GOLDEN_RECONSTRUCT))


@pytest.mark.parametrize("recorder", [False, True])
def test_train_step_hands_the_timer_the_same_stages(model, recorder):
    timer, rec = LoggingTimer(), timing.SpanRecorder()
    if recorder:
        with timing.recording(rec):
            _train_step(model, timer)
    else:
        _train_step(model, timer)
    assert timer.calls == GOLDEN_TRAIN_STEP
    assert bool(rec.spans) == recorder


def _children(rec, span):
    return [s for s in rec.spans if s.parent == span.id]


def test_recorded_reconstruct_is_one_request(recorded_reconstruct):
    rec, _, scene = recorded_reconstruct
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["reconstruct"] and rec.requests == 1
    assert all(s.request == 0 and s.end_ns is not None for s in rec.spans)
    iters = [s for s in rec.spans if s.name == "align_iter"]
    assert len(iters) == N_ITER
    phases = {s.id: s.name for s in rec.spans if s.name in ("align_phase1", "align_phase2")}
    assert all(phases.get(s.parent) for s in iters)
    for it in iters:
        assert [c.name for c in _children(rec, it)] == ["align_loss", "align_backward",
                                                        "align_adam"]
    pnp = [s for s in rec.spans if s.name == "align_pnp"]
    assert len(pnp) == 1
    assert [c.name for c in _children(rec, pnp[0])] == ["pnp_prep", "pnp_ransac", "pnp_refine"]
    where = {"pnp_frames": "align_pnp", "pnp_failed": "align_pnp",
             "align_eager_iters": "align_iter", "window_chunks": "reconstruct",
             "window_rows_padded": "reconstruct", "align_points": "reconstruct"}
    assert all(rec.spans[sid].name == where[name] for sid, _, name, _ in rec.counts)
    # on the CPU every aligner iteration is eager; one window a UNet call
    assert rec.totals() == {"pnp_frames": FRAMES, "pnp_failed": scene.pnp_failures,
                            "align_eager_iters": N_ITER, "window_chunks": scene.G,
                            "window_rows_padded": 0,
                            "align_points": scene.G * scene.S * scene.P}
    decodes = [s for s in rec.spans if s.name == "decode"]
    assert len(decodes) == 3
    for d in decodes:
        assert [c.name for c in _children(rec, d)] == ["decode_head"] * 2
    ddim = [s.name for s in rec.spans if s.name.startswith("ddim_step")]
    assert ddim == ["ddim_step_0", "ddim_step_1"] * 3


def test_recorded_train_step_spans(model):
    rec = timing.SpanRecorder()
    with timing.recording(rec):
        _train_step(model, LoggingTimer())
    names = {s.id: s.name for s in rec.spans}
    tree = [(s.name, names.get(s.parent)) for s in rec.spans]
    assert tree == ([("train_step", None), ("build", "train_step")]
                    + [("build_encode", "build")] * 5 + [("build_context", "build"),
                                                          ("forward_backward", "train_step"),
                                                          ("loss", "forward_backward"),
                                                          ("backward", "forward_backward"),
                                                          ("optimizer", "train_step"),
                                                          ("adam", "optimizer"),
                                                          ("ema", "optimizer")])
    assert {s.request for s in rec.spans} == {0}


def test_host_init_counts_frames_and_failures(model, recorded_reconstruct):
    """The host chain (numpy inputs): the same stage calls as before, and
    the PnP counters per frame."""
    preds = _reconstruct(model, None)[1]
    p = {k: v.numpy() for k, v in preds.items()}
    groups = sliding_windows(FRAMES, T, 2)
    al = GroupAligner(groups, p["pts3d"], p["conf"], (H, W), invdepth=p["inv_depth"],
                      trajs=p["traj"], config=AlignerConfig(n_iter=2, depth_traj_start_iter=1),
                      device="cpu")
    rec, timer = timing.SpanRecorder(), LoggingTimer()
    with timing.recording(rec):
        failures = init_from_group(al, p["pts3d"], p["conf"], timer=timer)
    assert timer.calls == GOLDEN_HOST_INIT
    assert rec.totals() == {"pnp_frames": FRAMES, "pnp_failed": failures}
    assert [s.name for s in rec.spans].count("align_pnp") == GOLDEN_HOST_INIT.count("align_pnp")
