"""`train --mesh dp,mp` of the port's CLI on the CPU (gloo): the command
starts dp * mp ranks itself (`parallel.launch`), mirroring the JAX CLI's
tests/test_train_cli.py::test_train_cli_mesh, and its state files cross
between a mesh and no mesh.

- `--mesh 4,2 --batch-size 4`: 8 ranks; prints `mesh: dp=4 mp=2 (8
  devices)` and the step lines once (rank 0), and the loss falls.
- A mesh run resumed from its state file equals a straight mesh run (the
  losses, and `--out` bit for bit).
- A state file saved under the mesh resumes without one, and one saved
  without a mesh resumes under it: the losses of the straight run within
  the printed 4 decimals, `--out` within 1e-4 of the straight run's
  largest entry of each tensor (sums in another order, then 4 AdamW
  steps, which divide by sqrt(nu): an entry whose gradient is near 0 can
  move by a larger part of its update; measured 1.0e-5 of the largest).
- `--batch-size` not divisible by dp, and an mp that does not divide the
  heads, are refused before a rank starts.
- A rank that fails (here: no weights file) fails the command with its
  traceback.

The straight run is a subprocess, as a user runs the command; the others
call `cli.main` here, and `capfd` reads what the ranks print to the file
descriptors they inherit. Tiny LM: 2 layers (one dense, one MoE), 4 heads, 8 experts.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from reference_torch import random_lm_flat  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

from deepseek_ocr2_tpu_torch import cli  # noqa: E402
from deepseek_ocr2_tpu_torch.configs import tiny_lm_config  # noqa: E402
from deepseek_ocr2_tpu_torch.io import load_flat, save_flat  # noqa: E402


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers

    cfg = tiny_lm_config(num_hidden_layers=2)
    d = tmp_path_factory.mktemp("torch_parallel_cli")
    save_flat(random_lm_flat(cfg, seed=4), str(d / "tiny.safetensors"))
    json.dump({"lm": dataclasses.asdict(cfg)}, open(d / "config.json", "w"))
    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(d / "tokenizer.json"))
    with open(d / "data.jsonl", "w") as f:
        for _ in range(8):
            f.write('{"text": "hello Free OCR. hello hello Free OCR. Free"}\n')
    return d


def _train(d, capfd, *extra):
    argv = ["train", "--backend", "cpu", "--weights", str(d / "tiny.safetensors"), "--tokenizer",
            str(d / "tokenizer.json"), "--config", str(d / "config.json"), "--data", str(d / "data.jsonl"),
            "--batch-size", "4", "--seq-len", "16", "--lr", "1e-3", *extra]
    assert cli.main(argv) == 0
    out, err = capfd.readouterr()
    return [float(line.split("loss")[1].split()[0]) for line in out.splitlines() if line.startswith("step ")], err


@pytest.fixture(scope="module")
def straight(assets):
    """A straight 4-step run under --mesh 4,2 in a subprocess, as a user
    runs it (its losses, stderr and --out), made once for the module."""
    import os
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    d = assets
    proc = subprocess.run(
        [sys.executable, "-m", "deepseek_ocr2_tpu_torch.cli", "train", "--backend", "cpu", "--weights",
         str(d / "tiny.safetensors"), "--tokenizer", str(d / "tokenizer.json"), "--config", str(d / "config.json"),
         "--data", str(d / "data.jsonl"), "--batch-size", "4", "--seq-len", "16", "--lr", "1e-3", "--mesh", "4,2",
         "--steps", "4", "--out", str(d / "straight.safetensors")],
        cwd=d, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [float(line.split("loss")[1].split()[0]) for line in proc.stdout.splitlines()
            if line.startswith("step ")], proc.stderr


def test_train_cli_mesh(straight):
    losses, err = straight
    assert "mesh: dp=4 mp=2 (8 devices)" in err
    assert "backend gloo" in err
    assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0]


def _close_to_straight(d, name):
    a, b = load_flat(str(d / "straight.safetensors")), load_flat(str(d / name))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0, atol=1e-4 * float(a[k].abs().max()), err_msg=k)


def test_mesh_resume_equals_straight(assets, straight, capfd):
    d = assets
    _train(d, capfd, "--mesh", "4,2", "--steps", "2", "--state-out", str(d / "mesh_state.safetensors"))
    resumed, err = _train(d, capfd, "--mesh", "4,2", "--steps", "4", "--resume", str(d / "mesh_state.safetensors"),
                          "--out", str(d / "resumed.safetensors"))
    assert "resumed from" in err and resumed == straight[0][2:]
    a, b = load_flat(str(d / "straight.safetensors")), load_flat(str(d / "resumed.safetensors"))
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)


def test_state_crosses_mesh_and_no_mesh(assets, straight, capfd):
    d = assets
    if not (d / "mesh_state.safetensors").exists():
        _train(d, capfd, "--mesh", "4,2", "--steps", "2", "--state-out", str(d / "mesh_state.safetensors"))
    plain, _ = _train(d, capfd, "--steps", "4", "--resume", str(d / "mesh_state.safetensors"),
                      "--out", str(d / "from_mesh.safetensors"))
    np.testing.assert_allclose(plain, straight[0][2:], atol=2e-4)
    _close_to_straight(d, "from_mesh.safetensors")
    _train(d, capfd, "--steps", "2", "--state-out", str(d / "plain_state.safetensors"))
    meshed, _ = _train(d, capfd, "--mesh", "4,2", "--steps", "4", "--resume", str(d / "plain_state.safetensors"),
                       "--out", str(d / "to_mesh.safetensors"))
    np.testing.assert_allclose(meshed, straight[0][2:], atol=2e-4)
    _close_to_straight(d, "to_mesh.safetensors")


@pytest.mark.parametrize("mesh,match", [("3,1", "--batch-size must be divisible by dp=3"),
                                        ("1,3", "mp=3 does not divide num_attention_heads=4")])
def test_mesh_shape_refusals(assets, capfd, mesh, match):
    with pytest.raises(SystemExit, match=match):
        _train(assets, capfd, "--mesh", mesh, "--steps", "1")


def test_a_failed_rank_fails_the_command(assets, capfd):
    """Every rank reads the weights; a missing file fails each rank, and the
    command exits with the first failure's traceback (no rank keeps going,
    nothing runs as one process instead)."""
    with pytest.raises(SystemExit, match="rank [01] failed:(.|\n)*missing.safetensors"):
        cli.main(["train", "--backend", "cpu", "--weights", str(assets / "missing.safetensors"), "--tokenizer",
                  str(assets / "tokenizer.json"), "--config", str(assets / "config.json"), "--data",
                  str(assets / "data.jsonl"), "--batch-size", "4", "--seq-len", "16", "--steps", "1",
                  "--mesh", "2,1"])
