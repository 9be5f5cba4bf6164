from sphexa_tpu_torch.neighbors.cell_list import (CellGrid, build_cell_list,
                                                  choose_level)
from sphexa_tpu_torch.neighbors.neighbor_list import (NeighborList,
                                                      build_neighbor_list,
                                                      gather_nbr)
