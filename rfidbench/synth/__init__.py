"""The benchmark's frozen capture generator.

Verbatim copies of the port's numpy modules that synthesize a reader
capture (``config.py``, ``sim/trace.py``, ``sim/tag.py``, ``tx/pie.py``,
``protocol/crc.py``, ``protocol/gen2.py``; themselves copies of the JAX
package's), frozen here so that a change to the program cannot change the
traffic it is measured on.  The tag's access and authentication paths
import modules that are not copied (``protocol/crypto.py``); no traffic of
the benchmark reaches them.
"""
