"""Device choice and checkpoint bookkeeping of the port."""
