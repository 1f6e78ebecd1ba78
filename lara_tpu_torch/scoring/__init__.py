from lara_tpu_torch.scoring.ribosum import RIBOSUM65N_FLOAT, ribosum65n_fixed, load_score_matrix

__all__ = ["RIBOSUM65N_FLOAT", "ribosum65n_fixed", "load_score_matrix"]
