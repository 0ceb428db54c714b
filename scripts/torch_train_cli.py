"""Drive the PyTorch port's `train` command in-process, the way a user runs it.

Writes a 2-layer LM at the default widths (one dense layer, one MoE layer
with 64 experts; bf16 weights drawn from a seed), a word-level tokenizer, a
text JSONL and a prompt/completion JSONL into `--dir`, then runs
`python -m deepseek_ocr2_tpu_torch.cli train` at the CLI's default batch
(B 4 x S 512 = 2048 rows, so the MoE layer runs kernels D and E forward and
E, S and T backward):
- 4 steps with `--log-file` and `--out`;
- 2 steps with `--state-out`, then `--resume` to step 4: the resumed
  losses equal the straight run's last two, and both `--out` files are
  bit-identical;
- 2 SFT steps on the prompt/completion file.
Prints the CLI's lines and each run's kernel launches, checks the losses
are finite and falling, and exits 1 if a check fails. The files are removed
at the end.

    python3 scripts/torch_train_cli.py                  # on the card
    python3 scripts/torch_train_cli.py --backend cpu --tiny --batch-size 2 --seq-len 16
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import counters, random_lm_hf_flat  # noqa: E402
from deepseek_ocr2_tpu_torch import cli  # noqa: E402
from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config, tiny_lm_config  # noqa: E402
from deepseek_ocr2_tpu_torch.io import load_flat, save_flat  # noqa: E402

WORDS = ["the", "page", "text", "line", "table", "figure", "caption", "reads", "of", "and"]


def write_assets(d: str, lm: DeepseekV2Config, seed: int) -> None:
    from tokenizers import Tokenizer, models, pre_tokenizers

    g = torch.Generator().manual_seed(seed)
    flat = random_lm_hf_flat(lm, lambda shape, std: (torch.randn(shape, generator=g) * std).to(torch.bfloat16))
    save_flat(flat, os.path.join(d, "lm.safetensors"))
    json.dump({"lm": dataclasses.asdict(lm)}, open(os.path.join(d, "config.json"), "w"))
    vocab = {"<unk>": 2, **{w: 10 + i for i, w in enumerate(WORDS)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(os.path.join(d, "tokenizer.json"))
    rng = torch.Generator().manual_seed(seed + 1)

    def sentence(n):
        return " ".join(WORDS[int(i)] for i in torch.randint(len(WORDS), (n,), generator=rng))

    with open(os.path.join(d, "text.jsonl"), "w") as f:
        for _ in range(64):
            f.write(json.dumps({"text": sentence(40)}) + "\n")
    with open(os.path.join(d, "sft.jsonl"), "w") as f:
        for _ in range(8):
            f.write(json.dumps({"prompt": sentence(12), "completion": sentence(20)}) + "\n")


def train(d: str, args, *extra: str, data: str = "text.jsonl"):
    """One `train` run in-process: (losses, ms per step, launches, stdout)."""
    argv = ["train", "--backend", args.backend, "--weights", os.path.join(d, "lm.safetensors"),
            "--tokenizer", os.path.join(d, "tokenizer.json"), "--config", os.path.join(d, "config.json"),
            "--data", os.path.join(d, data), "--batch-size", str(args.batch_size), "--seq-len",
            str(args.seq_len), "--lr", "1e-3", *extra]
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise SystemExit(f"train {' '.join(extra)} exited {rc}")
    lines = [line for line in out.getvalue().splitlines() if line.startswith("step ")]
    losses = [float(line.split("loss")[1].split()[0]) for line in lines]
    ms = [float(line.split()[-2]) for line in lines]
    launches = {k: fn.launches for k, fn in fns.items() if fn.launches}
    print(out.getvalue(), end="")
    print(f"  launches {launches}")
    return losses, ms, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.join(ROOT, "build", "train_cli"))
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny test LM instead of the default widths")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--seed", type=int, default=8)
    args = ap.parse_args()
    if args.backend == "cuda":
        print(torch.cuda.get_device_name(0))
    lm = tiny_lm_config(num_hidden_layers=2) if args.tiny else dataclasses.replace(
        DeepseekV2Config(), num_hidden_layers=2)
    d = args.dir
    os.makedirs(d, exist_ok=True)
    failures = []
    try:
        t0 = time.perf_counter()
        write_assets(d, lm, args.seed)
        print(f"assets: 2-layer LM (hidden {lm.hidden_size}, {lm.n_routed_experts} experts, vocab "
              f"{lm.vocab_size}), {os.path.getsize(os.path.join(d, 'lm.safetensors')) / 2**30:.2f} GiB, "
              f"written in {time.perf_counter() - t0:.1f} s")
        straight, ms, launches = train(d, args, "--steps", "4", "--log-file", os.path.join(d, "log.jsonl"),
                                       "--out", os.path.join(d, "straight.safetensors"))
        if not (len(straight) == 4 and all(map(math.isfinite, straight)) and straight[-1] < straight[0]):
            failures.append(f"straight losses {straight}")
        rows = args.batch_size * args.seq_len
        if args.backend == "cuda" and rows > 512 and not all(launches.get(k) for k in "DEST"):
            failures.append(f"D, E, S, T not all launched at {rows} rows: {launches}")
        print(f"steps 2-4: {sorted(ms[1:])[1]:.0f} ms median, {rows / sorted(ms[1:])[1] * 1e3:.0f} tokens/s")
        state = os.path.join(d, "state.safetensors")
        train(d, args, "--steps", "2", "--state-out", state, "--save-every", "2")
        resumed, _, _ = train(d, args, "--steps", "4", "--resume", state, "--out",
                              os.path.join(d, "resumed.safetensors"))
        a = load_flat(os.path.join(d, "straight.safetensors"))
        b = load_flat(os.path.join(d, "resumed.safetensors"))
        same = sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
        print(f"resume: losses {resumed} vs straight {straight[2:]}; --out files bit-identical: {same}")
        if resumed != straight[2:] or not same:
            failures.append("the resumed run differs from the straight one")
        sft, _, _ = train(d, args, "--steps", "2", data="sft.jsonl")
        if not (len(sft) == 2 and all(map(math.isfinite, sft))):
            failures.append(f"SFT losses {sft}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for f in failures:
        print(f"FAIL: {f}")
    print("train CLI: ok" if not failures else "train CLI: FAILED")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
