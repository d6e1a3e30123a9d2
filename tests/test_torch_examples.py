"""The port's example twins (examples/torch_*.py) in their quick modes on
the CPU, and each one's refusal to run without a card unless it is given
`--device cpu`. Each runs in its own process, capped at 2 threads, with
its artifacts under a temporary REPRO_ARTIFACTS."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train as launch_train

REPO_ROOT = os.path.join(os.path.dirname(__file__), "..")

# example -> (extra arguments, lines its quick run must print)
EXAMPLES = {
    "torch_quickstart.py": ([], ["[two-scale] selected", "[eq.4] aggregation weights",
                                 "[model] qwen1.5-0.5b (reduced) generated tokens",
                                 "[genfv] final accuracy", "[fl_only] final accuracy"]),
    "torch_serve_demo.py": ([], ["[serve] gemma2-9b (reduced): prefill 2x16 tokens",
                                 "[serve] decoded 4 tokens/seq", "  seq1: ["]),
    "torch_genfv_cifar.py": (["--schemes", "genfv,fedavg"],
                             ["=== summary (mean of last 3 rounds) ===", "  genfv      acc=",
                              "  fedavg     acc="]),
    "torch_train_backbone.py": ([], ["[train] olmoe-1b-7b (reduced):", "  step    5 loss",
                                     "(improved)"]),
    "torch_federated_lm.py": ([], ["[federated-lm] qwen1.5-0.5b (reduced), 4 clients",
                                   "  round 1: global-eval loss",
                                   "[federated-lm] done"]),
    "torch_diffusion_aigc.py": (["--ckpt-dir", "{tmp}"],
                                ["[pretrain] 2 steps, final loss", "[sample] (10, 32, 32, 3)",
                                 "[calib] t0 = ", "[genfv+ddpm] steps=  2 final accuracy",
                                 "[genfv+ddpm] steps=  4 final accuracy"]),
}


def _run(name, args, tmp_path):
    env = dict(os.environ, REPRO_ARTIFACTS=str(tmp_path), OMP_NUM_THREADS="2",
               PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    args = [a.replace("{tmp}", str(tmp_path)) for a in args]
    return subprocess.run([sys.executable, os.path.join(REPO_ROOT, "examples", name), *args],
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_quick_on_cpu(name, tmp_path):
    extra, lines = EXAMPLES[name]
    r = _run(name, ["--device", "cpu", "--quick", *extra], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    for line in lines:
        assert line in r.stdout, (line, r.stdout[-2000:])


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_refuses_to_run_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    r = _run(name, ["--quick"], tmp_path)
    assert r.returncode != 0
    assert "device 'cuda' requested but torch.cuda.is_available() is False" in r.stderr


def test_launcher_main_trains_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train` as a function: six steps of the
    reduced qwen1.5-0.5b, a checkpoint through the port's save_tree, and
    exit code 0 because the loss fell."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        ckpt = str(tmp_path / "qwen.npz")
        assert launch_train.main(["--arch", "qwen1.5-0.5b", "--steps", "6", "--device", "cpu",
                                  "--ckpt", ckpt]) == 0
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    assert "(improved)" in out and os.path.exists(ckpt), out[-2000:]
