"""Host-side BLS12-381 arithmetic over Python ints (constant tables), and
the signature API over the C host tier (`api`)."""
