"""kernel.k1_ctas_per_pair: the CTAs per pair of the window's K1 launches
(``dp_wave_kernel<false, false>``), graph replays included, from the
program's count of them by cluster size (``lara_tpu_torch._build.clusters``,
reset with the launch counts before the window): the mean over the
launches, so one placement reads as its size.  Nothing where the program
keeps no such count or K1 did not launch."""


def read(window):
    from lara_tpu_torch import _build

    counts = {ctas: n for (name, ctas), n
              in getattr(_build, "clusters", {}).items()
              if name == "gotoh_dp"}
    launched = sum(counts.values())
    if not launched:
        return None
    return sum(ctas * n for ctas, n in counts.items()) / launched
