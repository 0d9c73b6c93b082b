from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["make_decode_step", "make_prefill_step", "Request", "ServeEngine"]
