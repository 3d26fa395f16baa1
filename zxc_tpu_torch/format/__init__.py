"""Wire-format readers the device decode path needs (headers, hashes,
dictionary id)."""
