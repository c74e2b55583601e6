"""model_s_p90: The 90th percentile (linear between order statistics) of
one model's wall seconds over every model of the window: Line3D built,
views added, compute_3d_model, synchronize."""
import numpy as np


def read(record):
    if not record["model_s"]:
        return None
    return float(np.percentile(record["model_s"], 90))
