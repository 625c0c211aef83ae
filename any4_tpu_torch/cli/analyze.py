"""Weight/quantization analysis (counterpart of ``cli_analyze.py``, the
reference analyze.py equivalent): per-layer stats + per-format W/Y
quantization MSE to stats.csv, and plots.pdf.

  python -m any4_tpu_torch.cli.analyze --cpu --tiny --formats int4,nf4,any4 \\
      --log-dir /tmp/an
"""
from __future__ import annotations

import argparse

from .. import calibrate as cal
from ..evals import analyze, harness
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_model_args(p)
    p.add_argument("--formats", default="int4,nf4,any4")
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--log-dir", default="logs/analyze")
    p.add_argument("--calibration", default=None,
                   help=".npz from the calibrate script for sample weights")
    p.add_argument("--no-plots", action="store_true",
                   help="skip writing plots.pdf")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = common.device(args)

    harness.log_args(args.log_dir, vars(args))
    cfg, params = common.model(args, dev, vocab=512)
    sw = cal.load_calibration(args.calibration) if args.calibration else None

    rows = analyze.analyze_model(
        params, fmts=[f.strip() for f in args.formats.split(",")],
        group_size=args.group_size, sample_weights=sw,
        out_dir=args.log_dir, progress=True, device=dev)
    print(f"wrote {len(rows)} rows to {args.log_dir}/stats.csv")
    if not args.no_plots:
        path = analyze.write_plots(params, rows, args.log_dir)
        print(f"wrote {path}")
    return rows


if __name__ == "__main__":
    main()
