"""Wire-format readers the decode paths need (headers, hashes, varints,
dictionary id)."""
