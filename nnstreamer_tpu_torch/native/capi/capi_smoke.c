/* capi_smoke.c — end-to-end exercise of the port's C application API from
 * a plain C program (the analog of the reference's unittest_tizen_capi.cpp
 * pipeline and single-shot cases, run as a standalone binary).
 *
 * Covers: tensors_info/data CRUD, ml_single open/invoke/close with a
 * custom-python filter, ml_pipeline construct/start with appsrc →
 * tensor_transform → tensor_sink, sink callbacks, valve control, EOS wait.
 *
 * Usage: capi_smoke <passthrough.py> <device>, where <device> (cuda or cpu)
 * is given to the transform; the single-shot's device is [filter]
 * torch_device (NNSTPU_FILTER_TORCH_DEVICE).
 * Exits 0 on success; prints the failing check otherwise.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include "nnstreamer-capi.h"

#define CHECK(cond)                                                   \
  do {                                                                \
    if (!(cond)) {                                                    \
      fprintf (stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      exit (1);                                                       \
    }                                                                 \
  } while (0)

static int g_sink_count = 0;
static float g_last_value = 0.0f;

static void
sink_cb (const ml_tensors_data_h data, const ml_tensors_info_h info,
    void *user_data)
{
  void *raw;
  size_t size;
  unsigned int count;
  CHECK (ml_tensors_info_get_count (info, &count) == ML_ERROR_NONE);
  CHECK (count == 1);
  CHECK (ml_tensors_data_get_tensor_data (data, 0, &raw, &size) == ML_ERROR_NONE);
  CHECK (size == 4 * sizeof (float));
  g_last_value = ((float *) raw)[0];
  g_sink_count++;
  (void) user_data;
}

static void
test_info_data_crud (void)
{
  ml_tensors_info_h info;
  ml_tensors_data_h data;
  ml_tensor_dimension dim = {3, 4};
  ml_tensor_dimension got_dim;
  unsigned int count, rank;
  ml_tensor_type_e type;
  size_t size;
  void *raw;
  float payload[12];

  CHECK (ml_tensors_info_create (&info) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_set_count (info, 1) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_get_count (info, &count) == ML_ERROR_NONE && count == 1);
  CHECK (ml_tensors_info_set_tensor_type (info, 0, ML_TENSOR_TYPE_FLOAT32) ==
         ML_ERROR_NONE);
  CHECK (ml_tensors_info_get_tensor_type (info, 0, &type) == ML_ERROR_NONE &&
         type == ML_TENSOR_TYPE_FLOAT32);
  CHECK (ml_tensors_info_set_tensor_dimension (info, 0, 2, dim) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_get_tensor_dimension (info, 0, &rank, got_dim) ==
         ML_ERROR_NONE);
  CHECK (rank == 2 && got_dim[0] == 3 && got_dim[1] == 4);
  CHECK (ml_tensors_info_get_tensor_size (info, 0, &size) == ML_ERROR_NONE &&
         size == 48);

  CHECK (ml_tensors_data_create (info, &data) == ML_ERROR_NONE);
  for (int i = 0; i < 12; i++)
    payload[i] = (float) i;
  CHECK (ml_tensors_data_set_tensor_data (data, 0, payload, sizeof (payload)) ==
         ML_ERROR_NONE);
  CHECK (ml_tensors_data_get_tensor_data (data, 0, &raw, &size) == ML_ERROR_NONE);
  CHECK (size == 48 && ((float *) raw)[11] == 11.0f);

  /* negative: out-of-range index */
  CHECK (ml_tensors_info_set_tensor_type (info, 7, ML_TENSOR_TYPE_INT8) ==
         ML_ERROR_INVALID_PARAMETER);

  CHECK (ml_tensors_data_destroy (data) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_destroy (info) == ML_ERROR_NONE);
}

static void
test_single_shot (const char *model_path)
{
  ml_single_h single;
  ml_tensors_info_h in_info, out_info;
  ml_tensors_data_h in, out;
  ml_tensor_dimension dim = {4};
  unsigned int count;
  void *raw;
  size_t size;
  float payload[4] = {1.5f, -2.0f, 3.25f, 0.0f};

  CHECK (ml_tensors_info_create (&in_info) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_set_count (in_info, 1) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_set_tensor_type (in_info, 0, ML_TENSOR_TYPE_FLOAT32) ==
         ML_ERROR_NONE);
  CHECK (ml_tensors_info_set_tensor_dimension (in_info, 0, 1, dim) ==
         ML_ERROR_NONE);

  CHECK (ml_single_open (&single, model_path, "custom-python", NULL, in_info) ==
         ML_ERROR_NONE);
  CHECK (ml_single_set_timeout (single, 30000) == ML_ERROR_NONE);

  CHECK (ml_single_get_output_info (single, &out_info) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_get_count (out_info, &count) == ML_ERROR_NONE &&
         count == 1);

  CHECK (ml_tensors_data_create (in_info, &in) == ML_ERROR_NONE);
  CHECK (ml_tensors_data_set_tensor_data (in, 0, payload, sizeof (payload)) ==
         ML_ERROR_NONE);
  CHECK (ml_single_invoke (single, in, &out) == ML_ERROR_NONE);
  CHECK (ml_tensors_data_get_tensor_data (out, 0, &raw, &size) == ML_ERROR_NONE);
  CHECK (size == sizeof (payload));
  CHECK (memcmp (raw, payload, sizeof (payload)) == 0); /* passthrough echo */

  CHECK (ml_tensors_data_destroy (in) == ML_ERROR_NONE);
  CHECK (ml_tensors_data_destroy (out) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_destroy (in_info) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_destroy (out_info) == ML_ERROR_NONE);
  CHECK (ml_single_close (single) == ML_ERROR_NONE);
}

static void
test_pipeline (const char *device)
{
  ml_pipeline_h pipe;
  ml_pipeline_sink_h sink;
  ml_tensors_info_h info;
  ml_tensors_data_h data;
  ml_tensor_dimension dim = {4};
  ml_pipeline_state_e state;
  float payload[4];
  int i;

  char desc[512];
  snprintf (desc, sizeof (desc),
      "appsrc name=in caps='other/tensor, dimension=(string)4:1:1:1, "
      "type=(string)float32, framerate=(fraction)0/1' ! "
      "tensor_transform mode=arithmetic option=add:10.0 device=%s ! "
      "valve name=v ! tensor_sink name=out", device);

  CHECK (ml_pipeline_construct (desc, &pipe) == ML_ERROR_NONE);
  CHECK (ml_pipeline_sink_register (pipe, "out", sink_cb, NULL, &sink) ==
         ML_ERROR_NONE);
  CHECK (ml_pipeline_start (pipe) == ML_ERROR_NONE);
  CHECK (ml_pipeline_get_state (pipe, &state) == ML_ERROR_NONE &&
         state == ML_PIPELINE_STATE_PLAYING);

  CHECK (ml_tensors_info_create (&info) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_set_count (info, 1) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_set_tensor_type (info, 0, ML_TENSOR_TYPE_FLOAT32) ==
         ML_ERROR_NONE);
  CHECK (ml_tensors_info_set_tensor_dimension (info, 0, 1, dim) == ML_ERROR_NONE);
  CHECK (ml_tensors_data_create (info, &data) == ML_ERROR_NONE);

  for (i = 0; i < 3; i++) {
    int j;
    for (j = 0; j < 4; j++)
      payload[j] = (float) i;
    CHECK (ml_tensors_data_set_tensor_data (data, 0, payload,
               sizeof (payload)) == ML_ERROR_NONE);
    CHECK (ml_pipeline_src_input_data (pipe, "in", data) == ML_ERROR_NONE);
  }

  /* drain: the valve flip below must happen after frames 1-3 pass it */
  for (i = 0; i < 3000 && g_sink_count < 3; i++)
    usleep (10 * 1000);

  /* close the valve; the 4th frame must be dropped */
  CHECK (ml_pipeline_valve_set_open (pipe, "v", 0) == ML_ERROR_NONE);
  payload[0] = 99.0f;
  CHECK (ml_tensors_data_set_tensor_data (data, 0, payload, sizeof (payload)) ==
         ML_ERROR_NONE);
  CHECK (ml_pipeline_src_input_data (pipe, "in", data) == ML_ERROR_NONE);
  /* let the frame reach the (closed) valve before reopening */
  usleep (500 * 1000);
  CHECK (ml_pipeline_valve_set_open (pipe, "v", 1) == ML_ERROR_NONE);

  CHECK (ml_pipeline_src_input_eos (pipe, "in") == ML_ERROR_NONE);
  CHECK (ml_pipeline_wait (pipe, 30000) == ML_ERROR_NONE);

  CHECK (g_sink_count == 3);
  CHECK (g_last_value == 2.0f + 10.0f); /* transform add:10 applied */

  CHECK (ml_pipeline_sink_unregister (sink) == ML_ERROR_NONE);
  CHECK (ml_pipeline_stop (pipe) == ML_ERROR_NONE);
  CHECK (ml_tensors_data_destroy (data) == ML_ERROR_NONE);
  CHECK (ml_tensors_info_destroy (info) == ML_ERROR_NONE);
  CHECK (ml_pipeline_destroy (pipe) == ML_ERROR_NONE);
}

int
main (int argc, char **argv)
{
  if (argc < 3) {
    fprintf (stderr, "usage: %s <passthrough.py> <device>\n", argv[0]);
    return 2;
  }
  CHECK (ml_tpu_initialize () == ML_ERROR_NONE);
  test_info_data_crud ();
  printf ("info/data CRUD ok\n");
  test_single_shot (argv[1]);
  printf ("single-shot ok\n");
  test_pipeline (argv[2]);
  printf ("pipeline ok\n");
  return 0;
}
