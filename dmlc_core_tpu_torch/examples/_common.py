"""What the example ports share: the refusal of multi-worker runs and
the checkpoint directory beside the data."""

from __future__ import annotations

import os

from ..utils.logging import Error


def check_single_worker() -> None:
    """Raise on a tracker or a world larger than 1: the tracker, the
    launcher and the collectives are not ported (ROADMAP.md §1 item 4)."""
    uri = os.environ.get("DMLC_TRACKER_URI")
    world = int(os.environ.get("DMLC_NUM_WORKER", 1))
    if uri or world > 1:
        raise Error(
            f"a multi-worker run (DMLC_TRACKER_URI={uri!r}, DMLC_NUM_WORKER="
            f"{world}) needs the tracker and collectives, which are not ported "
            "(ROADMAP.md §1 item 4); run one process")


def ckpt_dir(data_path: str, name: str) -> str:
    """The checkpoint directory ``name`` beside the data file."""
    return os.path.join(os.path.dirname(os.path.abspath(data_path)), name)
