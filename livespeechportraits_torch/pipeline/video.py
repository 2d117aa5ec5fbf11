"""Host-side audio/video IO, shared with the JAX package.

``livespeechportraits_tpu/pipeline/video.py`` (``load_wav``, ``save_wav``,
``write_video``, ``make_test_tone``) imports no JAX itself, but its
package's ``__init__`` imports the JAX pipeline.  So the file is loaded here
by path, as a module of its own, and the JAX package stays unimported.
cv2 is optional there: ``write_video`` raises without it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import livespeechportraits_tpu

_PATH = Path(livespeechportraits_tpu.__file__).resolve().parent / "pipeline" / "video.py"
_spec = importlib.util.spec_from_file_location("livespeechportraits_torch.pipeline._tpu_video",
                                               _PATH)
_video = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_video)

cv2 = _video.cv2
load_wav = _video.load_wav
save_wav = _video.save_wav
write_video = _video.write_video
make_test_tone = _video.make_test_tone
