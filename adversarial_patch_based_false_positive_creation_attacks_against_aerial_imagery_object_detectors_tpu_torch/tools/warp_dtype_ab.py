"""A/B: does running the EOT warp and composite in bfloat16 cost attack
quality against the float32 path? (The repository's
``tools/warp_dtype_ab.py``.)

The harness of ``tools/warp_ab.py`` (the crafted brightness victim,
identical seeds and data, rotation on), but the axis under test is
``ExperimentConfig.warp_dtype``: the detector runs in float32 in both
runs, so only the dtype of the warp's matmuls, canvas temporaries and
composite changes. Both trained patches are pasted through the exact
float32 path (the evaluation protocol of record), with the same draws.
``--device`` defaults to cuda and raises where there is no card. Times
are not measured here.

    python -m <package>.tools.warp_dtype_ab [steps] [n_eval]
"""

from __future__ import annotations

from ..ops._cuda import resolve_device
from .warp_ab import (creation_row, format_row, parse, paste, paste_draws,
                      setup, train_with)


def train_patch(model, warp_dtype, imgs, labs, steps):
    return train_with(model, imgs, labs, steps, warp_dtype=warp_dtype)


def main(argv=None):
    args = parse(argv, __doc__)
    dev = resolve_device(args.device)
    det, (imgs, labs), (eval_imgs, eval_labs), clean = setup(args.n_eval,
                                                             dev)
    draws = paste_draws(args.n_eval, dev)
    table = []
    print("\nwarp-dtype  final-loss  M1@0.4  M2@0.4  M1@0.01  M2@0.01")
    for wd in ("float32", "bfloat16"):
        patch, loss = train_patch(det.model, wd, imgs, labs, args.steps)
        # exact float32 paste for both (the evaluation protocol of record)
        row = creation_row(det, paste(patch, eval_imgs, eval_labs, draws),
                           clean)
        table.append({"warp_dtype": wd, "final_loss": loss, **row})
        print(f"{wd:10s}  {loss:10.4f}  " + format_row(row), flush=True)
    return {"steps": args.steps, "n_eval": args.n_eval,
            "clean": {str(c): sum(len(d) for d in v)
                      for c, v in clean.items()},
            "table": table}


if __name__ == "__main__":
    main()
