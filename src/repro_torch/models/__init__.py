"""The LM stack of the serving path: configs' models with their
attention and Mamba scans on the port's kernels."""
from repro_torch.models.model import Model, param_descs
