"""lstm_unet_tpu — recurrent (ConvLSTM) U-Net cell-segmentation framework.

A from-scratch JAX/XLA rebuild of the capability surface of
``arbellea/LSTM-UNet`` (TF2/Keras reference; see SURVEY.md — the reference
mount was empty at survey time, so citations are file-level reconstructions):

- ``config``     — typed params (reference: Params.py)
- ``io``         — CTC TIFF ingestion + preprocessing (reference: DataHandeling.py)
- ``ops``        — compute primitives: ConvLSTM, convs, pooling, int8
                   quantization, on-device postprocess/CCL
- ``models``     — ULSTMnet2D equivalent (reference: Networks.py)
- ``engine``     — train / streaming-inference drivers (reference: train2D.py,
                   Inference2D.py)
- ``parallel``   — mesh/sharding (no reference analog: reference is single-GPU)
- ``metrics``    — SEG/DET scorers
- ``checkpoint`` — npz step checkpoints (reference: tf.train.Checkpoint)
- ``utils``      — logging, stall watchdog, compile cache
"""

__version__ = "0.1.0"
