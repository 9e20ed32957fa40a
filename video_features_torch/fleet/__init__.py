"""Fleet surfaces of the port: so far the shared second cache tier
(:mod:`.tier`, ``cache_l2_dir``). No torch at import."""
