"""chip_smoke.py on the CPU: every phase at a tiny size passes its own
comparison (the Triton kernels in interpret mode), the sharded --multi
paths match one device on four virtual CPU devices, main() refuses a
backend that is not a GPU, and the last line has the contract's shape."""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke as cs


def _assert_ok(checks):
    for c in checks:
        assert c["ok"], c


@pytest.fixture(scope="module")
def ys64():
    checks, _timing, extra, ys = cs.phase_robertson_f64(nbatch=16, nref=2)
    _assert_ok(checks)
    assert extra["steps"] > 100
    return ys


def test_phase_robertson_f64(ys64):
    assert ys64.shape == (len(cs.T_EVAL_4E10), 16, 3)


def test_phase_robertson_f32(ys64):
    checks, _timing, extra = cs.phase_robertson_f32(ys64, nbatch=16)
    _assert_ok(checks)
    assert extra["t_end"] == cs.T_EVAL_F32[-1]


def test_phase_heat2d_banded():
    checks, timing, _extra = cs.phase_heat2d_banded(mgrid=6, nbatch=2,
                                                    interpret=True)
    _assert_ok(checks)
    assert {"compile_s", "run_s", "xla_run_s"} <= set(timing)


def test_phase_heat1d_banded():
    _assert_ok(cs.phase_heat1d_banded(mgrid=15, nbatch=4, interpret=True)[0])


def test_phase_band_lu():
    checks, timing, _ = cs.phase_band_lu(
        shapes=((16, 1, 1, 8), (40, 2, 3, 4)), interpret=True)
    _assert_ok(checks)
    assert len(checks) == 2 and len(timing) == 4


def test_phase_foodweb_dae():
    checks, _timing, extra = cs.phase_foodweb_dae(nx=10, nbatch=2)
    _assert_ok(checks)
    assert extra["linear_solver"].startswith("banded(20,20")


def test_phase_robertson_ode_blockdiag():
    _assert_ok(cs.phase_robertson_ode_blockdiag(ngroups=4)[0])


def test_phase_adjoint_ensemble():
    _assert_ok(cs.phase_adjoint_ensemble(nbatch=8, ncheck=2)[0])


@pytest.mark.parametrize("path", ["robertson_dp", "heat1d_dp_sp",
                                  "training_step"])
def test_multi_paths_on_four_virtual_devices(path):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    if path == "robertson_dp":
        checks, _, extra = cs.multi_robertson_dp(devices, nbatch=8)
    elif path == "heat1d_dp_sp":
        checks, _, extra = cs.multi_heat1d_dp_sp(devices, mgrid=31)
    else:
        checks, _, extra = cs.multi_training_step(devices, nbatch=8)
    _assert_ok(checks)


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert "needs a GPU" in str(exc.value.code)
    assert '"ok": true' not in capsys.readouterr().out


def test_failed_check_stops_the_run(capsys):
    def failing_phase():
        return [cs.check("x", 2.0, 1.0, "test")], {}, {}

    with pytest.raises(cs.PhaseFailed):
        cs.run_phase("failing", failing_phase, "card")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "failing" and line["ok"] is False


def test_final_line_shape():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = cs.final_line([Dev()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1
    assert np.isclose(cs.tol_err([1.0], [1.0 + 1e-4], 1e-4, 0.0), 1.0,
                      rtol=1e-3)


def test_trace_reduction_on_a_recorded_h100_trace(tmp_path):
    """device_kernel_events on a trace recorded on an H100 of three runs of
    jit(lambda x: sin(x) @ x + 1) at 64x64 f64: three kernels per run."""
    src = Path(__file__).parent / "data" / "h100_tiny.xplane.pb"
    (tmp_path / "plugins").mkdir()
    shutil.copy(src, tmp_path / "plugins" / "run.xplane.pb")
    launches, copies, busy, window, top = cs.device_kernel_events(tmp_path)
    assert (launches, copies) == (9, 0)
    assert 0.0 < busy < window
    names = {name: count for name, count, _us in top}
    assert names["wrapped_sine"] == 3 and names["loop_add_fusion"] == 3
    assert any("gemm" in name for name in names)
