"""Host input: libffm parsing, feature hashing, padded batches."""
