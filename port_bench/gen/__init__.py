"""Edge-list generators, one module a ``generator`` named in a
configuration file: ``edges(config, seed, device) -> (src, dst)``."""
