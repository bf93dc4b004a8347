"""The port's server soaks (tools/torch_soak_*.py) on the CPU.

Each tool runs once in a subprocess on the plain versions
(``ASCIICHAT_TORCH_DEVICE=cpu``) with ``asciichat_tpu``, ``jax`` and
``jaxlib`` unimportable, for a short window and with the clients' uplink at
5 frames/s. Its one JSON line must carry exactly the keys of its JAX twin's
artifact (docs/artifacts/soak_*_r0*.json; the mixed-transport twin prints
its numbers as text, named here) plus the port's additions, and must show
no client death, no tick-loop error and no failed device tick. The cadence
gates belong to the full-length runs on the card, not to these windows.
The mixed-transport soak runs with ``zstandard`` unimportable too, as on
the card's machine: its clients then ask for uncompressed frames.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "docs" / "artifacts"
PRELUDE = ("import runpy, sys\n"
           "for name in ('asciichat_tpu', 'jax', 'jaxlib'{extra}):\n"
           "    sys.modules[name] = None\n"
           "sys.argv = [{tool!r}, {seconds!r}]\n"
           "runpy.run_path({tool!r}, run_name='__main__')\n")

# what every port soak adds to its twin's line (tools/torch_soak_common.port_keys)
PORT_KEYS = {"device", "card", "cpu_count", "uplink_fps", "downlink_zstd", "device_failures",
             "audio_failures", "audio_tick_latency", "kernel_launches", "loop_lag_ms",
             "device_memory"}
RSS_KEYS = {"rss_start_kib", "rss_peak_kib", "rss_samples_kib", "rss_postwarmup_drift_kib"}
# tools/soak_mixed.py's printed numbers, as the port's line names them
MIXED_TWIN_KEYS = {"soak", "seconds", "clients", "frames_delivered", "frames_per_s",
                   "per_client", "tick_rate", "ticks", "device_tick_computes",
                   "latency_p50_ms", "latency_p99_ms", "latency_worst_ms", "deadline_ms",
                   "ok"} | RSS_KEYS - {"rss_peak_kib"}


def _twin_keys(artifact: str) -> set[str]:
    return set(json.loads((ARTIFACTS / artifact).read_text()))


def run_soak(name: str, seconds: float, no_zstd: bool = False) -> dict:
    tool = str(REPO / "tools" / f"torch_soak_{name}.py")
    code = PRELUDE.format(extra=", 'zstandard'" if no_zstd else "", tool=tool,
                          seconds=str(seconds))
    env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu", SOAK_UPLINK_FPS="5",
               OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         stdin=subprocess.DEVNULL, capture_output=True, text=True,
                         timeout=seconds + 90)
    lines = out.stdout.splitlines()
    assert len(lines) == 2 and lines[1].startswith("RESULT:"), (
        out.stdout[-2000:], out.stderr[-3000:])
    assert out.returncode == (0 if lines[1] == "RESULT: OK" else 1)
    line = json.loads(lines[0])
    assert "died" not in line and "server_tick_error" not in line, line
    assert line["device"] == "cpu" and line["card"] is None and line["uplink_fps"] == 5.0
    assert line["device_failures"] == 0 and line["audio_failures"] == 0
    assert line["device_memory"] is None  # sampled only on the card
    assert set(line["kernel_launches"]) == {"resize_nn", "cell_records", "render_group",
                                            "mixer", "capture_chain", "device_emit"}
    assert not any(line["kernel_launches"].values())  # the CPU launches no kernel
    assert line["frames_delivered"] > 0 and line["tick_rate"] > 0
    assert line["loop_lag_ms"]["samples"] > 0
    return line


def test_latency_soak():
    line = run_soak("latency", 15)
    assert set(line) == _twin_keys("soak_latency_r04.json") | PORT_KEYS | RSS_KEYS
    assert line["soak"] == "latency_3client_60fps_cpu"
    assert line["latency_samples"] > 50


def test_nine_soak_with_churn():
    line = run_soak("nine", 22)
    assert set(line) == _twin_keys("soak_nine_r05.json") | PORT_KEYS
    assert line["soak"] == "nine_heterogeneous_churn_cpu"
    counts = line["per_client"]
    assert sorted(counts) == ["a1", "a2", "a3", "b1", "b2", "c1", "c2", "churn", "d1", "d2"]
    assert min(counts.values()) > 0
    # one churn cycle fits in the window: a join and a leave replan the layout
    assert line["churn_joins"] == 1 and line["layout_replans"] >= 2
    assert line["group_rebuilds"] >= 4  # the 4 render groups, then the churn client's


def test_thirtytwo_soak_refuses_the_33rd():
    line = run_soak("thirtytwo", 20)
    assert set(line) == (_twin_keys("soak_thirtytwo_r05.json") | PORT_KEYS
                         | {"stage_avg_ms", "rss_postwarmup_drift_kib"})
    assert line["clients"] == 32 and line["per_client_min"] > 0  # frames for all 32
    refusal = line["thirty_third"]
    assert refusal["attempted"] and refusal["refused"] and refusal["still_32"], refusal
    assert refusal["clients_at_attempt"] == 32 and refusal["frames"] == 0
    assert "server full" in refusal["error"]


def test_mixed_soak_without_zstandard():
    line = run_soak("mixed", 15, no_zstd=True)
    assert set(line) == MIXED_TWIN_KEYS | PORT_KEYS | {"stage_avg_ms", "rss_peak_kib"}
    assert line["downlink_zstd"] is False
    assert sorted(line["per_client"]) == ["rtc-1", "rtc-2", "tcp-1", "tcp-2", "ws-1", "ws-2"]
    assert min(line["per_client"].values()) > 0


def test_soak_tools_name_their_twins_gates():
    """The port's gates are the twins' (soak_nine.py:203-217,
    soak_thirtytwo.py:142-147, soak_latency.py:87-88)."""
    tools = REPO / "tools"
    nine = (tools / "torch_soak_nine.py").read_text()
    for gate in ("balance > 0.5", "churn_events >= 3",
                 "server.layout_replans >= 2 * churn_events",
                 "steady_ticks / steady_dt >= 59.4", 'lat["p99_ms"] < 16.67'):
        assert gate in nine and gate in (tools / "soak_nine.py").read_text(), gate
    t32 = (tools / "torch_soak_thirtytwo.py").read_text()
    for gate in ("balance > 0.3", 'refusal["attempted"] and refusal["refused"]'):
        assert gate in t32 and gate in (tools / "soak_thirtytwo.py").read_text(), gate
    gate = 'lat["p99_ms"] < deadline_ms'
    assert gate in (tools / "torch_soak_latency.py").read_text()
    assert gate in (tools / "soak_latency.py").read_text()

