"""Snapshot pinning: the offline half of the JAX package's `utils/hub.py`.

A snapshot's files can be verified against expected sha256 digests before
they load (`from_pretrained(..., expected_sha256=)`), so a snapshot whose
contents changed fails loudly instead of silently changing what loads. The
port takes a local snapshot directory only: downloading from the hub is not
ported.

    python -m f5_tts_tpu_torch.utils.hub <snapshot dir>   # prints its digests
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path


def sha256_file(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def verify_artifacts(root: Path, expected_sha256: dict[str, str]) -> None:
    """Check each (relative filename -> sha256 hex digest) entry; a missing
    file or a digest mismatch raises ValueError naming the offender."""
    for rel, want in expected_sha256.items():
        p = root / rel
        if not p.exists():
            raise ValueError(f"pinned artifact missing from snapshot: {rel}")
        got = sha256_file(p)
        if got != want.lower():
            raise ValueError(
                f"artifact digest mismatch for {rel}: expected {want}, got {got} "
                "— the snapshot's contents changed (or the pin is stale)"
            )


def main(argv: list[str] | None = None) -> None:
    """Print the sha256 digests of a local snapshot dir, in the form `expected_sha256=` takes."""
    ap = argparse.ArgumentParser(description="print snapshot artifact digests")
    ap.add_argument("snapshot", help="local snapshot directory")
    args = ap.parse_args(argv)
    root = Path(args.snapshot)
    digests = {
        str(p.relative_to(root)): sha256_file(p)
        for p in sorted(root.rglob("*"))
        if p.is_file()
    }
    print(json.dumps(digests, indent=2))


if __name__ == "__main__":
    main()
