"""Host codec layers of the port: frame options, the native encoder and
decoder and the in-place decode (``frame``), the section parse and host
block decode (``block_decode``), PivCo tables (``huffman``), the block
encoder from plaintext or from a device matcher's sequences
(``block_encode``), the push streams (``pstream``), the multi-threaded
file pipeline (``stream``), the dictionary trainer (``dict_train``) and
random access to seekable archives (``seekable``)."""
