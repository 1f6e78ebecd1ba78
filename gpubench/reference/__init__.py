"""The benchmark's plain reference: a frozen NumPy copy of the port's scalar
mirror of the LaRA 2 solver (``lara::Lagrange``, ``lara::SubgradientSolver``,
the greedy matching, the ebpseq reader and the T-Coffee writer).  It imports
``numpy`` and this package alone: nothing of the program it judges, and no
JAX."""
