"""Self-discarding background-task registry helper.

THE sanctioned spawn pattern the graftlint ``task-spawn`` rule
enforces for cluster daemons: a spawned task joins a set and discards
itself on completion, so per-op/per-event spawns never accumulate dead
Tasks for the daemon's life, while ``stop()`` can still cancel
whatever is live.  One implementation — messenger, OSD, and MDS all
delegate their ``_track`` here, so a change to the pattern (e.g.
surfacing a swallowed task exception) happens in exactly one place.
"""

from __future__ import annotations

import asyncio
from typing import Set


def track_task(registry: Set[asyncio.Task],
               task: asyncio.Task) -> asyncio.Task:
    registry.add(task)
    task.add_done_callback(registry.discard)
    return task
