"""Makers of a configuration's pool of records, one file a
``generator.kind``: ``<kind>.py`` with ``make(n, generator, seed,
workers)``, which returns ``n`` records (see ``generate.make_pool``).  The
kinds ``trna_family`` and ``long_family`` are built into ``generate.py``."""
