"""The frozen reference's ``control``, re-exported."""

from gpubench.reference.control import *  # noqa: F401,F403
