"""Pretrained-LM eigenvalue spectroscopy CLI (the lm_eigvals notebook flow),
counterpart of ``tools/lm_eigvals.py``.

    python -m tlie_tpu_torch.tools.lm_eigvals --model <local HF model dir> \\
        --cache_dir <dir> [--dataset wikitext] [--data_dir <dir>] \\
        [--batch_size 2] [--block_size 1024] [--max_batches 50] [--device cpu]

Loads a local Hugging Face causal LM (``transformers``, imported here only;
nothing is downloaded), puts it on the card unless ``--device cpu`` is
given, hooks its q/k projections, streams the dataset's test blocks through
it (WikiText from the pre-tokenized ``tokens_{train,test}.npy`` under
``--data_dir``: the port does not tokenize), extracts the softmax-attention
η per (layer, head) with resumable per-batch caching in ``--cache_dir``
(required: the tool writes nowhere by default), then threshold-bins and
writes the percentage arrays there.

:func:`run` is the part after loading: it takes any torch LM of a layout
:class:`tlie_tpu_torch.analysis.lm_spectra.QKHooks` reads and one of the
port's datasets.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
from torch import nn

from ..analysis.lm_spectra import bin_lm_spectra, lm_attention_spectra
from ..device import resolve_device


def run(model: nn.Module, dataset, num_heads: int, cache_dir: str, batch_size: int = 2,
        max_batches: Optional[int] = None) -> Dict[str, object]:
    """η of ``model`` over ``dataset``'s test inputs in batches of
    ``batch_size`` (the last partial batch left out), cached in
    ``cache_dir``; the binned percentages saved beside the cache.  Returns
    the summary the CLI prints: the shape of the spectra and the mean
    radius bins of the first layer's first head."""
    inputs = dataset.split("test")[0]

    def batches():
        for i in range(0, len(inputs) - batch_size + 1, batch_size):
            yield inputs[i: i + batch_size]

    all_eigs = lm_attention_spectra(model, batches(), num_heads, cache_dir,
                                    max_batches=max_batches)
    print(f"all_eigs: {all_eigs.shape} -> {cache_dir}/all_eigs.npy")
    stats = bin_lm_spectra(all_eigs)
    for k, v in stats.items():
        np.save(os.path.join(cache_dir, f"{k}.npy"), v)
    return {"shape": list(all_eigs.shape),
            "mean_radius_bins_first_layer": stats["percentage_mean"][:, 0, 0].tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="local Hugging Face model directory")
    ap.add_argument("--cache_dir", required=True)
    ap.add_argument("--dataset", default="wikitext")
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--block_size", type=int, default=1024)
    ap.add_argument("--max_batches", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from transformers import AutoConfig, AutoModelForCausalLM

    from ..data import DATASETS

    device = resolve_device(args.device)
    model = AutoModelForCausalLM.from_pretrained(args.model, local_files_only=True).to(device)
    hf_cfg = AutoConfig.from_pretrained(args.model, local_files_only=True)
    num_heads = getattr(hf_cfg, "num_attention_heads", 8)
    dataset = DATASETS[args.dataset](_name_=args.dataset, data_dir=args.data_dir,
                                     block_size=args.block_size)
    summary = run(model, dataset, num_heads, args.cache_dir, args.batch_size, args.max_batches)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
