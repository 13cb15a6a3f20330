"""Digests of the outputs of the tensor-core attention's callers in the
encoder backward, on seeded inputs.

    python -m veto_tpu_torch.tools.attention_digest [--tree DIR]

On a card, from inputs drawn by one seeded generator (the same bits on any
checkout with the same PyTorch), runs what ``chip_smoke.py`` phases 6 and 9
hold against their plain versions:

* B2b's attention alone (``fused_encoder._launch_attention_bwd``) with and
  without datt, at 12,288 pairs x 19 tokens and at 509 pairs with t_pad 24
  > t_valid 19, 576 wide, 6 heads;
* B5 (``fused_encoder._launch_mono_bwd``) with and without the qkv/x1
  stash at 12,288 pairs x 19, on the stash of B1's forward;

and prints one JSON line: the SHA-256 of each output's bytes and the card's
name and power limit.  Two checkouts whose lines hold the same digests gave
bit-equal outputs.  ``--tree`` runs the port of another checkout (for
example an earlier commit unpacked with ``git archive``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys


def digests(pairs: int = 12288, d: int = 576, f: int = 1152, heads: int = 6) -> dict:
    import torch

    from veto_tpu_torch.ops import fused_encoder as fe

    if not torch.cuda.is_available():
        raise RuntimeError("attention_digest runs the kernels on a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def sha(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    out, t = {}, 19
    with torch.inference_mode():
        for n, t_pad in ((pairs, t), (509, 24)):
            qkv = randn(n * t_pad, 3 * d).bfloat16()
            datt = randn(n * t_pad, d).bfloat16()
            att, dqkv = fe._launch_attention_bwd(qkv, datt, heads, t_pad, t)
            fwd, _ = fe._launch_attention_bwd(qkv, None, heads, t_pad, t)
            out.update({f"attention {n}x{t_pad} att": sha(att),
                        f"attention {n}x{t_pad} dqkv": sha(dqkv),
                        f"attention {n}x{t_pad} forward att": sha(fwd)})
            del qkv, datt, att, dqkv, fwd
        params = fe.EncoderLayerParams(
            ln1_scale=1 + randn(d, std=0.1), ln1_bias=randn(d, std=0.1),
            w_qkv=randn(d, 3 * d, std=d ** -0.5).bfloat16(),
            w_out=randn(d, d, std=d ** -0.5).bfloat16(), b_out=randn(d, std=0.1),
            ln2_scale=1 + randn(d, std=0.1), ln2_bias=randn(d, std=0.1),
            w1=randn(d, f, std=d ** -0.5).bfloat16(), b1=randn(f, std=0.1),
            w2=randn(f, d, std=f ** -0.5).bfloat16(), b2=randn(d, std=0.1))
        x = randn(pairs * t, d).bfloat16()
        dy = randn(pairs * t, d).bfloat16()
        _, qkv, x1 = fe._launch(x, params, heads, t, t, stash=True)
        for stash in (True, False):
            got = fe._launch_mono_bwd(x, qkv if stash else None, x1 if stash else None,
                                      dy, params, heads, t, t)
            for name, g in zip(("dx", "h2", "df1", "g", "vec", "db1", "dwqkv",
                                "dwout"), got):
                out[f"B5 stash {stash} {name}"] = sha(g)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=None,
                        help="root of another checkout whose port to run")
    args = parser.parse_args(argv)
    if args.tree:
        for name in [m for m in sys.modules if m.startswith("veto_tpu_torch")]:
            del sys.modules[name]
        sys.path.insert(0, args.tree)
    res = digests()
    res["tree"] = args.tree or "this checkout"
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
