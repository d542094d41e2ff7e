"""Golden-output regression gate (the reference regression.sh md5 parity).

The seeded library clip (conftest.sample_amv_bytes) and its decode are
frozen here.  The decode is bit-exact against the single-core C
implementation of the reference algorithms (native.ref_decode_frame,
native.ref_adpcm_decode); these md5s make any semantic regression in the
corpus generator, the entropy decoder, IDCT, assembly/flip or ADPCM
kernels fail loudly.
"""

import hashlib

import numpy as np

from amv_tpu.pipeline.decode import decode_file

CLIP_MD5 = "211cda7fa0cb1f235944e91c1fdc74f3"
GOLDEN = {
    "y": "9fa0ed5bfaf2753192ab894b5181fe78",
    "cb": "2a5a7a6b087b3f119c6a397d906b81ad",
    "cr": "b80ce3239e6216a236782898963d11b5",
    "pcm": "e441399640a4af7ec60e419d635faf18",
}


def test_corpus_decode_golden(sample_amv_path, sample_amv_bytes):
    assert hashlib.md5(sample_amv_bytes).hexdigest() == CLIP_MD5
    dec = decode_file(sample_amv_path)
    got = {
        "y": hashlib.md5(dec.y.tobytes()).hexdigest(),
        "cb": hashlib.md5(dec.cb.tobytes()).hexdigest(),
        "cr": hashlib.md5(dec.cr.tobytes()).hexdigest(),
        "pcm": hashlib.md5(dec.pcm.tobytes()).hexdigest(),
    }
    assert got == GOLDEN
    assert dec.y.shape == (48, 96, 128)
    assert dec.pcm.shape == (64000,)
    assert dec.pcm.dtype == np.int16
