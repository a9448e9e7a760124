"""The port's command line, ``python -m slamtpu_torch`` (``__main__.main``),
on the CPU against the reference's (``slamtpu.__main__.main``).

A 6-sweep replay of a small sensor (256 x 32 beams) with its config files
(the Ouster metadata, lidar, IMU and register JSON the ``--meta`` flags
read). Each app, run by both command lines for 3 keyframes, writes the same
set of files (the port with ``--device cpu``). The odom_ndt trajectory the
port's command line writes equals ``OdomNdtApp``'s on the same config bit
for bit; ``--loop-closure`` prints the closure count; ``--profile`` writes
a torch.profiler trace and prints the keyframe record's summary; ``"use_regmap": false`` in the register file runs
odom_ndt and lo_svn on the sorted-key path as the reference's command
line does; the default ``--device cuda`` fails without a card,
naming the flag; importing the module starts no CUDA context.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from slamtpu_torch import __main__ as tmain
from slamtpu_torch.apps.odom_ndt import OdomNdtApp
from slamtpu_torch.lidar.ouster import synthetic_os2_metadata
from slamtpu_torch.runtime import checkpoint
from slamtpu_torch.runtime.config import PipelineConfig
from tests.simulator_np import simulate_replay

torch.set_num_threads(1)
N_SWEEPS, MAX_KF = 6, 3
REGISTER = dict(registration_method="NDT_OMP", ndt_resolution=1.0, ndt_max_iterations=20,
                map_capacity=1 << 14, min_points_per_voxel=6, reg_grid_shape=[128, 128, 32],
                fused_inner_iters=1, svn_ndt_resolution=1.0, svn_ndt_number_particle=4,
                svn_ndt_max_iterations=3, keyframe_window=3, svn_polish_iters=1, mapvoxelsize=1.0)


def meta_json(meta):
    T = np.asarray(meta.lidar_to_sensor_transform, np.float64).copy()
    T[:3, 3] *= 1e3  # the file's translation is in mm
    return {
        "lidar_data_format": {"columns_per_frame": meta.columns_per_frame,
                              "pixels_per_column": meta.pixels_per_column,
                              "pixel_shift_by_row": np.asarray(meta.pixel_shift_by_row).tolist()},
        "config_params": {"columns_per_packet": meta.columns_per_packet,
                          "udp_profile_lidar": meta.udp_profile},
        "beam_intrinsics": {"beam_azimuth_angles": np.asarray(meta.beam_azimuth_deg).tolist(),
                            "beam_altitude_angles": np.asarray(meta.beam_altitude_deg).tolist(),
                            "lidar_origin_to_beam_origin_mm": meta.lidar_origin_to_beam_origin_mm},
        "lidar_intrinsics": {"lidar_to_sensor_transform": T.ravel().tolist()},
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    files = {"meta": meta_json(synthetic_os2_metadata(columns_per_frame=256, pixels_per_column=32,
                                                       columns_per_packet=16)),
             "lidar": {"lidar_parameter": {"channelStride": 1, "rangeFilter": [0.5, 150.0]}},
             "imu": {"imu_parameter": {}},
             "register": {"register_parameter": REGISTER}}
    flags = []
    for name, obj in files.items():
        path = str(d / f"{name}.json")
        with open(path, "w") as f:
            json.dump(obj, f)
        flags += [f"--{name}", path]
    cfg = PipelineConfig.from_files(*flags[1::2])
    replay = str(d / "run.rpl")
    simulate_replay(replay, cfg.meta, cfg.lidar, n_sweeps=N_SWEEPS)
    return d, replay, flags, cfg


def _run(main, app, setup, out, *extra):
    d, replay, flags, _ = setup
    out = str(d / out)
    assert main([app, "--replay", replay, "--out", out, "--max-keyframes", str(MAX_KF), *flags, *extra]) == 0
    return out


@pytest.mark.parametrize("app", tmain.APPS)
def test_each_app_writes_the_reference_files(setup, app):
    from slamtpu import __main__ as jmain

    ref = _run(jmain.main, app, setup, f"ref_{app}")
    port = _run(tmain.main, app, setup, f"port_{app}", "--device", "cpu")
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref)) and names, names
    if app == "calib_compass":
        with open(os.path.join(ref, "compass.csv")) as a, open(os.path.join(port, "compass.csv")) as b:
            assert a.read() == b.read()
    if "trajectory.npz" in names:
        jt, tt = (checkpoint.load_trajectory(os.path.join(o, "trajectory.npz")) for o in (ref, port))
        np.testing.assert_array_equal(tt[0], jt[0])  # timestamps
        assert len(tt[0]) == MAX_KF


def test_odom_trajectory_equals_the_app(setup):
    out = _run(tmain.main, "odom_ndt", setup, "port_odom_app", "--device", "cpu")
    traj = OdomNdtApp(setup[3], "cpu").run_replay(setup[1], MAX_KF)
    assert len(traj) == MAX_KF
    app_file = str(setup[0] / "odom_app.npz")
    checkpoint.save_trajectory(app_file, [e.timestamp for e in traj], [e.pose for e in traj],
                               [e.frame_id for e in traj])
    with np.load(os.path.join(out, "trajectory.npz")) as cli, np.load(app_file) as app:
        assert sorted(cli.files) == sorted(app.files)
        for k in app.files:
            np.testing.assert_array_equal(cli[k], app[k], err_msg=k)


def test_loop_closure_prints_the_count(setup, capsys):
    out = _run(tmain.main, "odom_ndt", setup, "port_loop", "--device", "cpu", "--loop-closure")
    assert "loop closures: 0" in capsys.readouterr().out  # a straight 6-sweep run revisits nothing
    assert os.path.exists(os.path.join(out, "trajectory.tum"))


def test_profile_writes_a_trace(setup):
    out = _run(tmain.main, "viz_lidar", setup, "port_profile", "--device", "cpu", "--profile")
    with open(os.path.join(out, "torch_trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_profile_prints_the_keyframe_record(setup, capsys):
    """``--profile`` switches on lo_svn's keyframe record: 3 keyframes, the
    poses published at the end (the second still on the host as the third
    begins), the CPU's work done as it is queued."""
    _run(tmain.main, "lo_svn", setup, "port_record", "--device", "cpu", "--profile")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("keyframes:")]
    assert len(lines) == 1
    assert re.fullmatch(r"keyframes: 2 after the first; pose latency p50 [0-9.]+ ms, p95 [0-9.]+ ms; "
                        r"device lag p95 0\.000 ms; in flight at most 1 on the host, 0 on the device", lines[0]), lines


@pytest.mark.parametrize("app", ["odom_ndt", "lo_svn"])
def test_sorted_key_register_file(setup, tmp_path, app):
    """``"use_regmap": false`` in the register file takes the app onto the
    sorted-key path: its trajectory equals the reference command line's
    within the replay parity bound (5e-4 m), and the ``--profile`` trace
    carries the stage names."""
    from slamtpu import __main__ as jmain

    d, replay, flags, _ = setup
    register = str(tmp_path / "register.json")
    with open(register, "w") as f:
        json.dump({"register_parameter": dict(REGISTER, use_regmap=False)}, f)
    flags = list(flags)
    flags[flags.index("--register") + 1] = register
    outs = {}
    for name, main, extra in (("ref", jmain.main, ()), ("port", tmain.main, ("--device", "cpu", "--profile"))):
        outs[name] = str(tmp_path / name)
        assert main([app, "--replay", replay, "--out", outs[name], "--max-keyframes", str(MAX_KF), *flags,
                     *extra]) == 0
    jt, tt = (checkpoint.load_trajectory(os.path.join(o, "trajectory.npz")) for o in (outs["ref"], outs["port"]))
    np.testing.assert_array_equal(tt[0], jt[0])  # timestamps
    np.testing.assert_allclose(np.asarray([p.trans for p in tt[1]]), np.asarray([p.trans for p in jt[1]]),
                               atol=5e-4)
    with open(os.path.join(outs["port"], "torch_trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    stages = {"odom_ndt": ("map_build", "newton"), "lo_svn": ("map_rebuild", "svn_particle_eval", "svn_polish")}
    assert set(stages[app]) <= names, names & set(stages[app])


def test_default_device_needs_a_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda"):
        _run(tmain.main, "odom_ndt", setup, "port_no_card")
    assert not os.path.exists(setup[0] / "port_no_card")


def test_import_starts_no_cuda():
    assert tmain.APPS and not torch.cuda.is_initialized()
