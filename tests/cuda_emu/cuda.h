// CPU stand-in for the driver header: its tensor-map types and encoder
// live with the runtime stand-in (cuda_runtime.h here).
#pragma once
#include "cuda_runtime.h"
