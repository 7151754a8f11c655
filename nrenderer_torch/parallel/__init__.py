"""Rendering split across devices: the counterpart of
`nrenderer_tpu/parallel/`."""
