"""Host-side C++ of the port, built with g++ at first use and bound with
ctypes (``build.py``): the ASCII PLY writer and reader behind ``io/ply.py``
and the CRC-32C behind ``models/tf_checkpoint.py``."""
