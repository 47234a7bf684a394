"""Device milliseconds a forward spends on WavLM's relative-position bias
(``adfmsl_torch/models/w2v2.py``): the union of the kernel intervals inside
the device-side spans of the program's ``stage.w2v2.relpos`` (the bias table,
once a forward) and ``stage.w2v2.gate`` (each layer's gate, its scores' f32
copy and ``g * bias`` added to them) spans, and of every span recorded inside
them, over the traced window's forwards (``w2v2_attention_ms.eval``'s
reading). A program without the spans gives nothing to read."""
from benchlib.readers import load_reader

UNIT = "ms"
SPANS = ("stage.w2v2.relpos", "stage.w2v2.gate")


def read(ctx):
    return load_reader("w2v2_attention_ms.eval").device_ms(ctx, SPANS)
