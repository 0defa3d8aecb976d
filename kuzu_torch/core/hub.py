"""Local-first model hub + download utilities (a copy of ``kuzu/core/hub.py``,
which the port may not import: the same ``KUZU_HUB_DIR``, the same
``model.json`` manifest, so both packages read one registry).

Parity: the reference's ``hub/session.py`` (model upload/resume sessions)
and ``utils/downloads.py`` (``safe_download``/``attempt_download_asset``),
re-imagined for air-gapped machines: the registry is a content-addressed
directory on shared storage (``KUZU_HUB_DIR`` or ``~/.cache/kuzu/hub``)
instead of a SaaS endpoint — publishing a run copies its checkpoint +
args + metrics there with sha256 manifests, and any ``Model`` API accepts
``hub://<name>`` wherever a run directory is accepted. ``safe_download``
keeps the reference's URL surface for ``file://`` and local paths and
fails with an explicit message for network schemes (zero-egress hosts).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import zipfile
from pathlib import Path

__all__ = [
    "hub_dir",
    "publish",
    "list_models",
    "resolve",
    "safe_download",
    "check_file",
]


def hub_dir() -> Path:
    d = os.environ.get("KUZU_HUB_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "kuzu", "hub"
    )
    p = Path(d)
    p.mkdir(parents=True, exist_ok=True)
    return p


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def publish(run_dir: str | Path, name: str | None = None) -> Path:
    """Publish a training run into the local hub (reference
    ``hub/session.py::upload_model``): copies checkpoints (``weights/``,
    ``ckpt/``), ``args.yaml``, ``data_spec.yaml`` and ``results.csv`` under
    ``<hub>/<name>`` with a sha256 manifest."""
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        raise FileNotFoundError(f"run dir not found: {run_dir}")
    name = name or run_dir.name
    dest = hub_dir() / name
    if dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True)
    manifest: dict[str, str] = {}
    # the port's run dir keeps its checkpoints in weights/ and its classes in
    # data_spec.yaml; JAX's list names ckpt/ only, which its runs do not write
    for item in ("ckpt", "weights", "args.yaml", "data_spec.yaml", "results.csv"):
        src = run_dir / item
        if not src.exists():
            continue
        if src.is_dir():
            shutil.copytree(src, dest / item)
            for f in sorted((dest / item).rglob("*")):
                if f.is_file():
                    manifest[str(f.relative_to(dest))] = _sha256(f)
        else:
            shutil.copy2(src, dest / item)
            manifest[item] = _sha256(dest / item)
    if not manifest:
        shutil.rmtree(dest)
        raise FileNotFoundError(f"{run_dir} has no ckpt/args.yaml to publish")
    task = ""
    args = run_dir / "args.yaml"
    if args.exists():
        import yaml

        task = str((yaml.safe_load(args.read_text()) or {}).get("task", ""))
    (dest / "model.json").write_text(
        json.dumps(
            {
                "name": name,
                "task": task,
                "source": str(run_dir),
                "published": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "files": manifest,
            },
            indent=2,
        )
    )
    return dest


def list_models() -> list[dict]:
    out = []
    for meta in sorted(hub_dir().glob("*/model.json")):
        try:
            out.append(json.loads(meta.read_text()))
        except json.JSONDecodeError:
            continue
    return out


def resolve(spec: str | Path, verify: bool = False) -> Path:
    """``hub://<name>`` -> local run directory (checksum-verified when
    ``verify``). Non-hub specs pass through unchanged."""
    s = str(spec)
    if not s.startswith("hub://"):
        return Path(s)
    name = s[len("hub://") :]
    dest = hub_dir() / name
    meta = dest / "model.json"
    if not meta.exists():
        known = ", ".join(m["name"] for m in list_models()) or "<empty>"
        raise FileNotFoundError(
            f"hub model '{name}' not found in {hub_dir()} (have: {known}); "
            f"publish one with `python -m kuzu_torch.tools.hub publish <run_dir>`"
        )
    if verify:
        files = json.loads(meta.read_text())["files"]
        for rel, want in files.items():
            got = _sha256(dest / rel)
            if got != want:
                raise ValueError(f"hub model '{name}': {rel} sha256 mismatch")
    return dest


def safe_download(
    url: str,
    dest: str | Path | None = None,
    sha256: str | None = None,
    unzip: bool = False,
    retries: int = 3,
) -> Path:
    """Fetch a ``file://`` URL or local path into ``dest`` with optional
    checksum verification and unzip (reference
    ``utils/downloads.py::safe_download``). Network schemes raise with an
    explicit message on air-gapped hosts rather than hanging."""
    if url.startswith("file://"):
        src = Path(url[len("file://") :])
    elif "://" not in url:
        src = Path(url)
    else:
        # zero-egress first: try, but fail fast and loud
        import urllib.error
        import urllib.request

        dest = Path(dest or Path(url).name)
        last: Exception | None = None
        for _ in range(max(1, retries)):
            try:
                urllib.request.urlretrieve(url, dest)  # noqa: S310
                break
            except (urllib.error.URLError, OSError) as e:
                last = e
        else:
            raise ConnectionError(
                f"cannot download {url}: no network egress on this host "
                f"(last error: {last}); stage the file locally and pass a "
                f"file:// URL or path instead"
            )
        src = dest
        dest = None
    if not src.exists():
        raise FileNotFoundError(src)
    out = Path(dest) if dest else src
    if dest and Path(dest).resolve() != src.resolve():
        out.parent.mkdir(parents=True, exist_ok=True)
        if src.is_dir():
            if out.exists():
                shutil.rmtree(out)
            shutil.copytree(src, out)
        else:
            shutil.copy2(src, out)
    if sha256 and out.is_file():
        got = _sha256(out)
        if got != sha256:
            raise ValueError(f"{out}: sha256 {got} != expected {sha256}")
    if unzip and out.suffix == ".zip":
        target = out.with_suffix("")
        with zipfile.ZipFile(out) as z:
            z.extractall(target)
        return target
    return out


def check_file(name: str | Path) -> Path:
    """Resolve a file argument: existing path as-is, else ``hub://`` lookup
    (reference ``utils/checks.py::check_file`` minus the URL fetch)."""
    p = Path(str(name))
    if p.exists():
        return p
    if str(name).startswith("hub://"):
        return resolve(name)
    raise FileNotFoundError(f"{name} does not exist and is not a hub:// model")
