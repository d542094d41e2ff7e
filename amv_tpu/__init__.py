"""amv_tpu: an AMV / G.729A codec framework in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of
tomvanbraeckel/amv-codec-tools: AMV container mux/demux, the AMV MJPEG-variant
video codec, the AMV IMA-ADPCM audio codec, and the G.729A speech codec.
"""

__version__ = "0.1.0"
