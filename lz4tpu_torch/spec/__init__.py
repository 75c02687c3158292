"""The port's own copies of the LZ4 format's constants, tables, errors and xxHash32."""
