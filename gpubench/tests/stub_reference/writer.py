"""The frozen reference's ``writer``, re-exported."""

from gpubench.reference.writer import *  # noqa: F401,F403
