"""The LM serving path: prefill/decode step functions and the
continuous-batching replicas behind a routing callback."""
from repro_torch.serving.serve_loop import Replica, Request, ServingCluster
from repro_torch.serving.steps import make_prefill_step, make_serve_step
