"""The frozen reference's ``params``, re-exported."""

from gpubench.reference.params import *  # noqa: F401,F403
