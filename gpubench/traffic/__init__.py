"""The benchmark's traffic: one generator (:mod:`.generate`) and one data
file per traffic mix (``<name>.json``)."""
