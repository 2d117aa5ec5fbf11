"""LiveSpeechPortraits on PyTorch and CUDA (NVIDIA Hopper).

The port of the offline inference path of ``livespeechportraits_tpu``:

    wav -> log-mel (ops/mel.py) -> APC GRU encoder (models/apc.py)
        -> KNN + LLE projection (ops/manifold.py)
        -> Audio2Feature LSTM (models/audio2feature.py)
        -> Audio2Headpose WaveNet + GMM decode (models/audio2headpose.py)
        -> smoothing and projection (ops/smoothing.py, ops/geometry.py)
        -> edge-map rasteriser (ops/rasterize_cuda.py)
        -> Feature2Face U-Net (models/feature2face.py) -> uint8 frames

Module names follow the JAX package so that each counterpart is easy to
find.  The three Pallas kernels of that package are CUDA C++ kernels here
(``csrc/``), built with nvcc at first use (``_build.py``); each has a plain
PyTorch twin that runs for CPU tensors.  This package never imports JAX.
"""

__version__ = "0.1.0"
