from repro_torch.serve.engine import GenerateResult, ServeEngine, make_sample_decode

__all__ = ["GenerateResult", "ServeEngine", "make_sample_decode"]
