from sphexa_tpu_torch.io.hdf5 import (HDF5Reader, HDF5Writer, load_checkpoint,
                                      save_checkpoint)
