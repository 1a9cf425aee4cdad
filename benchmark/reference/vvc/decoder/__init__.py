"""Subset VVC decoder used for conformance/round-trip verification.

Decodes the feature set our encoder emits (and the reference encoder's
tools-off configuration) to anchor spec conformance without an external
decoder: if this decoder — which shares all derivation code with the
encoder — reconstructs a reference-encoder stream at the expected PSNR,
the shared model is spec-correct.
"""

from .decoder import decode_stream
