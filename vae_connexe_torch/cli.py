"""Command line of the port: sample from or serve generator artifacts.

    python -m vae_connexe_torch.cli generate gen.vcxt --seed 0 --out s.npy
    python -m vae_connexe_torch.cli serve gen.vcxt --port 8799

Both run on the card unless ``--device cpu`` is given.  ``export`` restores
a phase-2 training checkpoint and comes with the training slice.
"""

from __future__ import annotations

import argparse
import json


def _cmd_serve(args):
    """Run the HTTP serving daemon on one or more artifacts."""
    from vae_connexe_torch.server import GeneratorServer

    arts = args.artifact if len(args.artifact) > 1 else args.artifact[0]
    srv = GeneratorServer(arts, host=args.host, port=args.port,
                          device=args.device)
    print(json.dumps({"serving": args.artifact, "host": srv.host,
                      "port": srv.port, "batch": srv.meta["batch"],
                      "routes": sorted(srv._artifacts),
                      "serve_dtype": srv.meta.get("serve_dtype", "float32"),
                      "warmup_s": round(srv._warmup_s, 3)}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


def _cmd_generate(args):
    """Sample from an artifact."""
    import numpy as np

    from vae_connexe_torch.serving import load_generator

    fn, meta = load_generator(args.artifact, args.device)
    samples = fn(args.seed)
    result = {"artifact": args.artifact, "meta": meta, "seed": args.seed,
              "shape": list(samples.shape)}
    if args.out:
        np.save(args.out, samples)
        result["saved"] = args.out
    print(json.dumps(result, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vae_connexe_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_g = sub.add_parser("generate", help="sample from an artifact")
    p_g.add_argument("artifact", help="artifact path from export_generator")
    p_g.add_argument("--seed", type=int, default=0)
    p_g.add_argument("--out", default=None, help=".npy path for samples")
    p_g.add_argument("--device", default=None,
                     help="torch device (default cuda)")
    p_g.set_defaults(fn=_cmd_generate)

    p_s = sub.add_parser("serve", help="HTTP serving daemon for artifacts "
                                       "(GET /healthz /artifacts "
                                       "/meta[/<name>], POST "
                                       "/generate[/<name>] with optional "
                                       "n_samples)")
    p_s.add_argument("artifact", nargs="+",
                     help="artifact path(s); the first is the default "
                          "route, each is also served at "
                          "/generate/<file-stem>")
    p_s.add_argument("--host", default="127.0.0.1")
    p_s.add_argument("--port", type=int, default=8799)
    p_s.add_argument("--device", default=None,
                     help="torch device (default cuda)")
    p_s.set_defaults(fn=_cmd_serve)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
