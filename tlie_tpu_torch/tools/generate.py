"""Generate tokens from a checkpoint of the port (the serving CLI),
counterpart of ``tools/generate.py``.

    python -m tlie_tpu_torch.tools.generate <checkpoint.pth> --n_new 64 \\
        [--prompt 12,55,7 | --batch 4 --prompt_len 16] [--seed 0] \\
        [--temperature 0.8 --top_k 40 --top_p 0.9] \\
        [--state_dtype bfloat16] [--device cpu]

The checkpoint is a ``.pth`` written by training (``{"model", "config"}``,
:func:`tlie_tpu_torch.training.save_checkpoint`); the decoder runs on the
card unless ``--device cpu`` is given.  With no ``--prompt`` each of the
``--batch`` rows is a random prompt of ``--prompt_len`` ids drawn from
``numpy.random.default_rng(seed)`` over the vocabulary, as ``tools/generate.py``
draws it; prompt ids outside the vocabulary raise.  ``--temperature`` 0
(the default) is greedy; above 0 each token is drawn from a
``torch.Generator`` seeded with ``--seed``, the logits divided by the
temperature and then filtered by ``--top_k`` and ``--top_p``.  Prints the
whole token matrix (prompt and generated tokens), one row per line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..inference import Decoder

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="a .pth checkpoint of the port")
    ap.add_argument("--n_new", type=int, default=64)
    ap.add_argument("--prompt", type=str, default=None,
                    help="comma-separated token ids (a single row)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt_len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--top_p", type=float, default=0.0)
    ap.add_argument("--state_dtype", choices=sorted(STATE_DTYPES), default="float32",
                    help="the dtype of the large decode states")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dec = Decoder.from_checkpoint(args.checkpoint, device=resolve_device(args.device),
                                  state_dtype=STATE_DTYPES[args.state_dtype])
    if args.prompt:
        prompt = np.asarray([[int(t) for t in args.prompt.split(",")]], np.int64)
    else:
        rng = np.random.default_rng(args.seed)
        prompt = rng.integers(0, dec.vocab, (args.batch, args.prompt_len)).astype(np.int64)
    generator = None
    if args.temperature > 0.0:
        generator = torch.Generator(device=dec.device).manual_seed(args.seed)
    out = dec.generate(prompt, args.n_new, temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p, generator=generator)
    for row in out.cpu().numpy():
        print(" ".join(str(int(t)) for t in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
