"""The plain reference that judges the port's ANSI frames.

Plain NumPy and Python, written from the reference C renderer's rules
(zfogg/ascii-chat: lib/util/aspect_ratio.c, lib/video/image.c:267-328,
lib/video/ascii/ascii.c:194-517, lib/video/ascii/common.c:380-430 and the
scalar renderers). It imports nothing of the program under test and takes
nothing it made: from the same frames and the configuration it works out the
geometry, the 16.16 fixed-point resize indices, each mode's cells and the
bytes. A mode is a file of its own, ``modes/<mode>.py``, found by name.
"""
