"""The port's native (C++) host library: the PNG decoder, the prefetching
frame loader and the `.map` serializer, built with g++ at first use into
``<repo>/build/native/`` and loaded with ctypes (``native.loader``)."""
