"""The port's numpy oracles (its own copies of cpprcoder_tpu/reference/),
behind the codecs' `backend="ref"`."""
