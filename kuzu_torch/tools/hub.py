"""Hub CLI: publish/list/resolve models in the local registry.

Usage:
    python -m kuzu_torch.tools.hub publish <run_dir> [name]
    python -m kuzu_torch.tools.hub list
    python -m kuzu_torch.tools.hub resolve hub://<name>

Parity: the reference's hub session CLI surface (``hub/__init__.py``)
against the air-gapped local registry (``kuzu_torch/core/hub.py``; a copy
of ``kuzu/tools/hub.py``).
"""

from __future__ import annotations

import json
import sys

from kuzu_torch.core.hub import list_models, publish, resolve


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return
    cmd, *rest = argv
    if cmd == "publish":
        dest = publish(rest[0], rest[1] if len(rest) > 1 else None)
        print(dest)
    elif cmd == "list":
        for m in list_models():
            print(json.dumps(m))
    elif cmd == "resolve":
        print(resolve(rest[0], verify=True))
    else:
        raise SystemExit(f"unknown command {cmd}")


if __name__ == "__main__":
    main()
