"""sdrpp_tpu — a JAX software-defined-radio signal-chain framework.

Brand-new JAX/XLA/Pallas implementation of the capabilities of qrp73/SDRPP's
receive chain (see SURVEY.md): batched IQ blocks through jit'd kernels
instead of sample-streaming C++ threads. Subpackages:

- ``ops``      — DSP kernels (windows/taps/FIR/resampling/mix/scans/FFT)
- ``models``   — demodulator compositions (AM/SSB/CW/NFM/WFM, digital)
- ``parallel`` — device-mesh sharding: VFO banks, time-axis halo exchange
- ``io``       — WAV IQ ingest/egress, wire formats
- ``utils``    — block/chain execution model, config, logging
"""

__version__ = "0.1.0"
