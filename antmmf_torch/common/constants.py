"""Framework-wide constants.

Own copy of what the port uses of ``antmmf_tpu/common/constants.py``.
"""

# the label of a token that is not a masked-LM target
LM_IGNORE_INDEX = -1
