"""Host codec layers of the port: frame options and the native encoder
and decoder (``frame``), the section parse and host block decode
(``block_decode``), PivCo tables (``huffman``), the emitters of the device
encoder (``block_encode``) and random access to seekable archives
(``seekable``)."""
