"""Code-state pinning for experiments and export bundles.

A copy of ``rtfs_tpu/utils/code_version.py``. The reference snapshots
``src/models`` into the experiment dir and evals against the snapshot
(reference ``train.py:95``, ``test.py:33-36``), so a checkpoint is always
paired with the code that produced it. The port records the git SHA (+
dirty flag) of its checkout into ``conf.json`` and the export bundle
instead of copying source trees; ``rtfs_tpu_torch.test`` warns when the
bundle's code version does not match the code it is being evaluated with.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def code_version(repo_root: str = _REPO_ROOT) -> Dict[str, str]:
    """Return {"git_sha": ..., "git_dirty": "true"|"false"}.

    Falls back to ``{"git_sha": "unknown"}`` outside a git checkout (e.g.
    an installed wheel) — pinning is best-effort, never fatal.
    """
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=repo_root, capture_output=True, text=True, timeout=10,
        )
        if sha.returncode != 0:
            return {"git_sha": "unknown"}
        status = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=repo_root, capture_output=True, text=True, timeout=10,
        )
        dirty = bool(status.stdout.strip()) if status.returncode == 0 else True
        return {
            "git_sha": sha.stdout.strip(),
            "git_dirty": "true" if dirty else "false",
        }
    except (OSError, subprocess.SubprocessError):
        return {"git_sha": "unknown"}


def check_code_version(bundle_infos: Dict) -> str | None:
    """Compare a loaded bundle's pinned code version against the current
    checkout. Returns a human-readable warning string on mismatch, else
    None. Unknown versions (either side) never warn."""
    pinned = (bundle_infos or {}).get("code_version") or {}
    pinned_sha = pinned.get("git_sha", "unknown")
    if pinned_sha == "unknown":
        return None
    cur = code_version()
    if cur["git_sha"] == "unknown":
        return None
    if cur["git_sha"] != pinned_sha:
        return (
            f"model bundle was exported at framework commit "
            f"{pinned_sha[:12]} (dirty={pinned.get('git_dirty', '?')}) but "
            f"is being evaluated with {cur['git_sha'][:12]} "
            f"(dirty={cur['git_dirty']}) — results may not reproduce the "
            f"training-time code"
        )
    if pinned.get("git_dirty") == "true":
        return (
            f"model bundle was exported from a DIRTY working tree at "
            f"{pinned_sha[:12]} — the exact training-time code is not "
            f"recoverable from the SHA alone"
        )
    return None
