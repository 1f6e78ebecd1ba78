"""The frozen reference's ``records``, re-exported."""

from gpubench.reference.records import *  # noqa: F401,F403
