"""Circuit applications: bitstring sampling."""

from tnco_tpu_torch.app.circuit.sampling import (Sampler, sample,
                                                 SamplingIntermediateState)

__all__ = ['Sampler', 'sample', 'SamplingIntermediateState']
