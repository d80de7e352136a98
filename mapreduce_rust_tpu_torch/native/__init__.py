"""Native host tier: the C++ one-pass normalize/tokenize/dedupe/hash/count
scanner (loader.cpp), built with g++ at first use and bridged via ctypes
(host.py). No pure-Python fallback."""
