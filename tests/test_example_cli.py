"""End-to-end smoke of the example CLI on simulated data (CPU)."""

import subprocess
import sys
import os

import numpy as np
import pytest


@pytest.mark.parametrize("preset,extra", [
    # scanned eval (2 batches/dispatch incl. a ragged tail) through the
    # full driver — CPU auto would pick 1, so force it
    ("flagship", ["--d_model", "32", "--layers", "1", "--heads", "2",
             "--eval_steps_per_call", "2"]),
    ("parity", []),
    # pre-LN blocks + custom softmax-head dims through the full driver
    ("parity", ["--norm_style", "pre", "--head_dims", "64,32"]),
])
def test_train_cli_simulated(tmp_path, preset, extra):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(repo, "examples", "bert4rec", "train.py"),
            "--simulated", "--n_items", "40", "--n_sessions", "300",
            "--model_dir", str(tmp_path / preset),
            "--preset", preset, "--epochs", "2", "--batch", "32",
            "--eval_batches", "2", "--max_items", "20", *extra,
        ],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done" in out.stdout
    assert (tmp_path / preset / "history.jsonl").exists()
    assert (tmp_path / preset / "export" / "model_config.json").exists()


@pytest.mark.parametrize("script,extra", [
    (
        os.path.join("examples", "chained", "train.py"),
        ["--n_items", "60", "--n_sessions", "200", "--max_hist", "10"],
    ),
    (
        os.path.join("examples", "tasks", "multilabel.py"),
        ["--n_items", "60", "--n_sessions", "200", "--max_items", "10"],
    ),
])
def test_task_driver_cli(tmp_path, script, extra):
    """The chained-binary (pos_weight) and multilabel drivers run end to
    end."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [
            sys.executable, os.path.join(repo, script),
            "--model_dir", str(tmp_path / "run"),
            "--epochs", "2", "--batch", "32", *extra,
        ],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done" in out.stdout
    assert (tmp_path / "run" / "history.jsonl").exists()


def test_bench_tiny_cpu_sanity():
    """bench.py measures the GPU only: off it, it exits non-zero and prints
    no record. Its flagship step itself trains at a tiny size on the CPU."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py")],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "GPU" in out.stderr

    sys.path.insert(0, repo)
    try:
        import bench
    finally:
        sys.path.remove(repo)
    scan_step, state, stacked, rng = bench.build(n_items=200, batch=8, steps=3, max_items=10)
    _, times, losses = bench.time_windows(scan_step, state, stacked, rng, windows=1)
    assert len(times) == 1 and times[0] > 0
    assert losses.shape == (3,) and np.all(np.isfinite(losses)) and losses[-1] > 0


def test_long_context_bench_cli():
    """The long-context bench times the per-head path off the GPU, and
    refuses the cuDNN path there instead of timing something else."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    cmd = [
        sys.executable,
        os.path.join(repo, "examples", "long_context", "bench.py"),
        "--seq_len", "128", "--batch", "4", "--items", "500",
        "--d_model", "32", "--layers", "1", "--heads", "2", "--steps", "2",
    ]
    out = subprocess.run(
        cmd + ["--impls", "xla"], capture_output=True, text=True, timeout=420, env=env
    )
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [
        float(line.split("loss ")[1].rstrip(")\n"))
        for line in out.stdout.splitlines()
        if "ms/step" in line
    ]
    assert len(losses) == 1 and np.isfinite(losses[0]), out.stdout
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=420, env=env)
    assert out.returncode != 0 and "needs the GPU" in out.stderr
    assert "ms/step" not in out.stdout


def test_train_cli_data_parallel(tmp_path):
    """--parallel dp trains the parity config over all virtual devices —
    the reference's MirroredStrategy story, end to end through the CLI."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        PYTHONPATH="",
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(repo, "examples", "bert4rec", "train.py"),
            "--simulated", "--n_items", "40", "--n_sessions", "300",
            "--model_dir", str(tmp_path / "dp"),
            "--preset", "parity", "--epochs", "2", "--batch", "32",
            "--eval_batches", "2", "--max_items", "20", "--parallel", "dp",
        ],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "data-parallel over 8 devices" in out.stdout
    assert "done" in out.stdout
    assert (tmp_path / "dp" / "export" / "model_config.json").exists()


def test_train_cli_steps_per_call(tmp_path):
    """--steps_per_call runs the scan multi-step path end to end."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(repo, "examples", "bert4rec", "train.py"),
            "--simulated", "--n_items", "40", "--n_sessions", "300",
            "--model_dir", str(tmp_path / "scan"),
            "--preset", "parity", "--epochs", "2", "--batch", "32",
            "--eval_batches", "2", "--max_items", "20",
            "--steps_per_epoch", "4", "--steps_per_call", "4",
            "--parallel", "none",
        ],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "scan train step: 4 steps/dispatch" in out.stdout
    assert "done" in out.stdout


def test_train_cli_dp_scan(tmp_path):
    """DP + scan: K steps per dispatch inside shard_map, through the CLI."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        PYTHONPATH="",
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(repo, "examples", "bert4rec", "train.py"),
            "--simulated", "--n_items", "40", "--n_sessions", "300",
            "--model_dir", str(tmp_path / "dpscan"),
            "--preset", "parity", "--epochs", "2", "--batch", "32",
            "--eval_batches", "2", "--max_items", "20", "--parallel", "dp",
            "--steps_per_epoch", "4", "--steps_per_call", "2",
        ],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DP scan train step: 2 steps/dispatch" in out.stdout
    assert "done" in out.stdout


def test_multivariable_cli_serves(tmp_path):
    """(action, item) example trains, exports, and serves dict sessions."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(repo, "examples", "bert4rec", "multivariable.py"),
            "--model_dir", str(tmp_path / "mv"),
            "--epochs", "2", "--n_sessions", "400", "--n_items", "60",
            "--max_items", "12",
        ],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "serving top-5:" in out.stdout
    assert "done" in out.stdout


def test_train_cli_prepared_dir(tmp_path):
    """prepare_data output directory feeds train.py --data directly — the
    reference's prep-once/train-many workflow (data_prep/main.py writes,
    source/main.py reads)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # synthesize a small 'user item' pairs file
    pairs = tmp_path / "pairs.txt"
    import numpy as np

    rng = np.random.default_rng(0)
    with open(pairs, "w") as f:
        for u in range(60):
            for it in rng.integers(0, 40, size=8):
                f.write(f"u{u} i{it}\n")
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    prepared = tmp_path / "prepared"
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(repo, "examples", "bert4rec", "prepare_data.py"),
            "--input", str(pairs), "--output", str(prepared),
            "--max_seq_len", "20",
        ],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(repo, "examples", "bert4rec", "train.py"),
            "--data", str(prepared),
            "--model_dir", str(tmp_path / "run"),
            "--preset", "parity", "--epochs", "1", "--batch", "16",
            "--eval_batches", "1", "--max_items", "20",
        ],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done" in out.stdout
