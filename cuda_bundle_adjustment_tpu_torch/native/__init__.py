"""Host C++ of the port: the symbolic analysis (``symbolic.cpp``), built
with ``g++`` at first use by :mod:`.build`."""
