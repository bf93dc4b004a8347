"""The port's ServerTick and tick_compute (models/server.py) against the JAX
package's: 10 ticks of video and audio with a rainbow receiver among the
filters, state carried over from JAX by utils/convert.py. Records are
exact; mixes are held to rtol=2e-4, atol=2e-5 (tests/test_audio.py's bound
for the JAX mixer)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asciichat_tpu.models import server as jserver
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.models import server as tserver
from asciichat_tpu_torch.ops import audio as taudio
from asciichat_tpu_torch.utils import convert

from test_torch_audio import speech

SIZES = [(80, 60), (64, 48), (50, 70), (72, 54)]
FILTERS = ["none", "rainbow", "green", "black"]
TOL = dict(rtol=2e-4, atol=2e-5)
CAPS = [TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK),
        TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(ticks: int, seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (ticks, len(SIZES), 70, 80, 3), dtype=np.uint8)
    audio, active = speech(seed, len(SIZES), 480, ticks)
    return frames, audio, active


@pytest.mark.parametrize("caps", CAPS, ids=lambda c: c.renderer_key())
def test_server_tick_matches_jax(caps):
    jplan = jserver.plan_tick(SIZES, 100, 30, caps)
    tplan = tserver.plan_tick(SIZES, 100, 30, caps)
    assert dataclasses.astuple(tplan.render) == dataclasses.astuple(jplan.render)
    assert (tplan.num_clients, tplan.audio_samples) == (jplan.num_clients, jplan.audio_samples)
    jt = jserver.ServerTick(jplan, client_filters=FILTERS)
    tt = tserver.ServerTick(tplan, client_filters=FILTERS, device="cpu")
    frames, audio, active = _inputs(10, seed=3)
    for k in range(10):
        time_s = 0.4 + 0.37 * k  # the rainbow tint moves every tick
        jrec, jmix = jt.step(jnp.asarray(frames[k]), jnp.asarray(audio[k]),
                             jnp.asarray(active[k]), time_s)
        trec, tmix = tt.step(torch.from_numpy(frames[k]), torch.from_numpy(audio[k]),
                             torch.from_numpy(active[k]), time_s)
        assert sorted(trec) == sorted(jrec)
        for name in jrec:
            np.testing.assert_array_equal(trec[name].numpy(), np.asarray(jrec[name]),
                                          err_msg=f"tick {k} {name}")
        np.testing.assert_allclose(tmix.numpy(), np.asarray(jmix), **TOL, err_msg=f"tick {k}")
    for got, want in zip(tt.mixer_state, jt.mixer_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_server_tick_continues_from_jax_state():
    caps = CAPS[0]
    jt = jserver.ServerTick(jserver.plan_tick(SIZES, 90, 26, caps), client_filters=FILTERS)
    frames, audio, active = _inputs(8, seed=5)
    for k in range(4):
        jt.step(jnp.asarray(frames[k]), jnp.asarray(audio[k]), jnp.asarray(active[k]), 1.0)
    tt = tserver.ServerTick(tserver.plan_tick(SIZES, 90, 26, caps), device="cpu")
    tt.load_state({**convert.group_arrays(jt),
                   "mixer_state": tuple(np.asarray(a) for a in jt.mixer_state)})
    tt.group.set_filters(FILTERS)  # the names drive the per-tick rainbow refresh
    for k in range(4, 8):
        jrec, jmix = jt.step(jnp.asarray(frames[k]), jnp.asarray(audio[k]),
                             jnp.asarray(active[k]), 2.0 + k)
        trec, tmix = tt.step(torch.from_numpy(frames[k]), torch.from_numpy(audio[k]),
                             torch.from_numpy(active[k]), 2.0 + k)
        for name in jrec:
            np.testing.assert_array_equal(trec[name].numpy(), np.asarray(jrec[name]))
        np.testing.assert_allclose(tmix.numpy(), np.asarray(jmix), **TOL)


def test_tick_compute_is_render_plus_mix():
    """On the CPU, tick_compute is the plain render_compute and
    mixer_process_reference, and launches nothing."""
    caps = CAPS[0]
    tt = tserver.ServerTick(tserver.plan_tick(SIZES, 100, 30, caps), client_filters=FILTERS,
                            device="cpu")
    frames, audio, active = _inputs(1, seed=8)
    f, a, act = (torch.from_numpy(x[0]) for x in (frames, audio, active))
    ramp, tint, fg, rb, on, maps = tt.consts
    r = tt.plan.render
    geo = dict(mode=r.mode, dst_h=r.dst_h_px, dst_w=r.dst_w)
    launches = (tserver.RENDER_GROUP_KERNEL.launches, taudio.MIXER_KERNEL.launches)
    records, mixes, state = tserver.tick_compute(f, a, act, tt.mixer_state, *tt.consts, **geo)
    want = tserver.render_compute(f, ramp, tint, fg, rb, on, maps.cidx, maps.src_y,
                                  maps.src_x, maps.comp_mask, **geo)
    want_mix, want_state = taudio.mixer_process_reference(a, act, tt.mixer_state)
    assert all(torch.equal(records[k], want[k]) for k in want)
    assert torch.equal(mixes, want_mix)
    assert all(torch.equal(x, y) for x, y in zip(state, want_state))
    assert launches == (tserver.RENDER_GROUP_KERNEL.launches, taudio.MIXER_KERNEL.launches)


def test_server_tick_default_filters_and_empty_receivers():
    caps = CAPS[1]
    plan = tserver.plan_tick(SIZES, 100, 30, caps)
    assert tserver.ServerTick(plan, device="cpu").group.filter_names == ["none"] * 4
    empty = tserver.ServerTick(tserver.plan_tick(SIZES, 100, 30, caps, num_clients=0),
                               client_filters=[], device="cpu")
    assert empty.group.n_real == 0 and empty.mixer_state[0].shape == (0,)
