"""Serving CLI: export an artifact from a reference-layout checkpoint, or
run the HTTP server over one (mirrors ``examples/serve.py``).

    # export: cfg + weights (.pth with the reference openpoints names)
    python -m adaptpoint_tpu_torch.serving export \
        --cfg cfgs/scanobjectnn/pointnext-s.yaml \
        --pretrained ckpt.pth --out /tmp/pointnext_s_torch [--fused-eval]

    # serve on the GPU
    python -m adaptpoint_tpu_torch.serving run --artifact /tmp/pointnext_s_torch --port 8000

    # query
    curl -s -X POST --data-binary @clouds.npy 'http://localhost:8000/predict'

Both commands run on the card; ``--device cpu`` asks for the plain PyTorch
versions on the CPU.
"""
from __future__ import annotations

import argparse


def _state_dict(path: str):
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


def cmd_export(args, opts) -> None:
    from ..models import build_model_from_cfg
    from ..utils import EasyConfig
    from .artifact import export_serving_artifact

    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    cfg.update_opts(opts)
    model = build_model_from_cfg(cfg.model, device=args.device)
    model.load_state_dict(_state_dict(args.pretrained))
    in_channels = int(cfg.model.get("in_channels", None)
                      or cfg.model.encoder_args.in_channels)
    manifest = export_serving_artifact(
        model, args.out, num_points=int(cfg.num_points),
        in_channels=in_channels,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        fused_eval=args.fused_eval,
        extra_manifest={"cfg_path": args.cfg, "checkpoint": args.pretrained})
    print(f"exported {manifest['model_name']} -> {args.out} "
          f"(buckets {manifest['batch_sizes']}, fused_eval "
          f"{manifest['fused_eval']})")


def cmd_run(args, _opts) -> None:
    from .server import serve_forever
    serve_forever(args.artifact, host=args.host, port=args.port,
                  device=args.device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("python -m adaptpoint_tpu_torch.serving")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="reference .pth -> serving artifact")
    ex.add_argument("--cfg", required=True)
    ex.add_argument("--pretrained", required=True,
                    help="state_dict with the reference openpoints names")
    ex.add_argument("--out", required=True)
    ex.add_argument("--batch-sizes", default="1,8,32")
    ex.add_argument("--fused-eval", action="store_true",
                    help="serve through the fused eval SA kernel")
    ex.add_argument("--device", default=None)
    run = sub.add_parser("run", help="HTTP server over an artifact")
    run.add_argument("--artifact", required=True)
    run.add_argument("--host", default="0.0.0.0")
    run.add_argument("--port", type=int, default=8000)
    run.add_argument("--device", default=None)
    args, opts = ap.parse_known_args(argv)
    if args.cmd == "export":
        cmd_export(args, opts)
    else:
        cmd_run(args, opts)


if __name__ == "__main__":
    main()
