"""The numpy golden decoder: the port's bit-exact oracle, on the host
(:mod:`.decoder`, :mod:`.recon`, :mod:`.idct`, :mod:`.mc`)."""
