"""Viewer CLI: serve the orbit viewer of a checkpoint.

Counterpart of :mod:`tetranerf_tpu.scripts.viewer`, with the same flags
plus ``--device`` (default ``cuda``; the CPU takes ``--device cpu``)::

    tetranerf-torch-viewer --checkpoint outputs/scene/final --data data/scene \
        [--tetrahedra-path tetra.npz] [--port 7007]
    python -m tetranerf_torch.scripts.viewer ...

Open http://localhost:7007: drag to orbit, wheel to dolly; a held pose
refines to full quality by re-shading its cached march
(:mod:`tetranerf_torch.viewer`).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tetranerf-torch-viewer")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--data", required=True)
    parser.add_argument("--tetrahedra-path", default=None)
    parser.add_argument("--method", default="tetra-nerf")
    parser.add_argument("--port", type=int, default=7007)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; the CPU only when asked "
                        "for with --device cpu)")
    args = parser.parse_args(argv)

    from ..training.cli import check_device
    from ..viewer import ViewerServer
    from .render import load_trainer

    device = check_device(args.device)
    trainer, _ = load_trainer(args.checkpoint, args.data, "train", args.tetrahedra_path,
                              args.method, device)
    print(f"viewer at http://localhost:{args.port}", file=sys.stderr)
    ViewerServer(trainer, port=args.port).start(background=False)


def entrypoint():
    main()


if __name__ == "__main__":
    main()
