"""Run metadata (``meta``).  The rest of the JAX package's ``obs/`` (the
registry, trace bus, spans, flight recorder, watchers) is not ported."""
